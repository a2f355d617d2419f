"""The port's counter registry, histograms, metric catalog and stats tracker
(``areal_tpu_torch/base/{metrics,stats_tracker}.py``) against
``areal_tpu``'s on the same scripts: every ``state()``, percentile,
summary, ``delta`` and ``export_state`` is compared exactly, and the two
catalogs must hold the same names with the same kinds.

Scripts are drawn from a numpy seed; values are multiples of 1/64 so the
histogram sums are exact in either order.
"""

import numpy as np
import pytest

from areal_tpu.base import metrics as ref_metrics
from areal_tpu.base import stats_tracker as ref_stats
from areal_tpu_torch.base import metrics as pt_metrics
from areal_tpu_torch.base import stats_tracker as pt_stats

PKGS = {"ref": ref_metrics, "port": pt_metrics}


def _values(seed, n):
    rng = np.random.default_rng(seed)
    # log-uniform over the default edges' range, on a 1/64 grid
    v = np.exp(rng.uniform(np.log(1e-3), np.log(5e3), n))
    return [float(np.round(x * 64) / 64) for x in v]


@pytest.mark.parametrize("boundaries", [
    None, ref_metrics.VERSION_LAG_BOUNDARIES,
    ref_metrics.POOL_OCCUPANCY_BOUNDARIES, [1.0, 10.0, 100.0]])
@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_matches_the_reference(boundaries, seed):
    vals = _values(seed, 300)
    reps = np.random.default_rng(seed + 10).integers(1, 4, len(vals))
    hs = {}
    for name, m in PKGS.items():
        h = m.Histogram(boundaries)
        for v, n in zip(vals, reps):
            h.observe(v, int(n))
        other = m.Histogram(boundaries)
        for v in vals[:50]:
            other.observe(v * 2)
        h.merge(other)
        hs[name] = h
    ref, port = hs["ref"], hs["port"]
    assert port.state() == ref.state()
    assert port.summary() == ref.summary()
    for q in (0, 1, 10, 25, 50, 75, 90, 95, 99, 99.9, 100):
        assert port.percentile(q) == ref.percentile(q)
    # the state round-trips into the other package's class
    assert ref_metrics.Histogram.from_state(port.state()).state() == ref.state()
    assert pt_metrics.Histogram.from_state(ref.state()).state() == port.state()
    # an empty histogram and a mismatched merge behave alike
    assert pt_metrics.Histogram().summary() == ref_metrics.Histogram().summary()
    with pytest.raises(ValueError):
        port.merge(pt_metrics.Histogram([0.5]))


def _registry_script(m, seed):
    """The same add / peak / gauge / observe / clear script on a fresh
    registry of package ``m``; returns what the script read back."""
    rng = np.random.default_rng(seed)
    reg = m.CounterRegistry()
    catalog = [m.FT_CLIENT_RETRIES, m.GEN_TOKENS, m.TRAIN_STEPS,
               m.GUARD_ANOMALOUS_STEPS, "custom/sum"]
    out = []
    before = None
    for i in range(120):
        op = int(rng.integers(0, 6))
        if op == 0:
            reg.add(catalog[int(rng.integers(0, len(catalog)))],
                    float(rng.integers(0, 9)))
        elif op == 1:
            reg.peak(m.PIPE_FWD_MAX_IN_FLIGHT, float(rng.integers(0, 9)))
        elif op == 2:
            reg.gauge(m.GEN_SPEC_K_CURRENT, float(rng.integers(1, 9)))
        elif op == 3:
            name = [m.STALENESS_VERSIONS, m.QUEUE_WAIT_S,
                    m.GEN_KV_POOL_OCCUPANCY][int(rng.integers(0, 3))]
            reg.observe(name, float(rng.integers(0, 64)) / 64 * 4,
                        n=int(rng.integers(1, 3)))
        elif op == 4 and i % 7 == 0:
            reg.clear(m.GEN_TOKENS)
        else:
            reg.register_kind("custom/peak", m.KIND_PEAK)
            reg.peak("custom/peak", float(i))
        if i == 40:
            before = reg.snapshot()
        if i % 30 == 29:
            out.append(("delta", reg.delta(before or {})))
            out.append(("summaries", reg.histogram_summaries()))
    out.append(("export", reg.export_state()))
    out.append(("kinds", {k: reg.kind(k) for k in reg.snapshot()}))
    out.append(("get", reg.get(m.TRAIN_STEPS), reg.get("missing", -1.0)))
    h = reg.histogram(m.STALENESS_VERSIONS)
    out.append(("hist", h.state() if h is not None else None))
    reg.reset()
    out.append(("reset", reg.export_state()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counter_registry_matches_the_reference(seed):
    assert _registry_script(pt_metrics, seed) == _registry_script(
        ref_metrics, seed)


def test_the_catalogs_are_equal_name_for_name_and_kind_for_kind():
    def catalog(m):
        return {k: v for k, v in vars(m).items()
                if k.isupper() and not k.startswith("_")}

    assert catalog(pt_metrics) == catalog(ref_metrics)
    assert set(pt_metrics.METRIC_KINDS.items()) == set(
        ref_metrics.METRIC_KINDS.items())
    assert pt_metrics.HISTOGRAM_BOUNDARIES == ref_metrics.HISTOGRAM_BOUNDARIES
    # every ft/ and guard/ name is in the catalog
    names = {v for v in catalog(pt_metrics).values() if isinstance(v, str)}
    assert {"ft/client_retries", "guard/rollbacks", "trace/dropped",
            "staleness_versions", "gen/served"} <= names


def test_the_process_global_registry_is_a_counter_registry():
    assert isinstance(pt_metrics.counters, pt_metrics.CounterRegistry)
    assert pt_metrics.counters.kind(pt_metrics.TTFC_S) == "histogram"
    assert pt_metrics.counters.kind("never/seen") == "sum"


def test_registry_is_thread_safe():
    import threading

    reg = pt_metrics.CounterRegistry()

    def bump():
        for _ in range(2000):
            reg.add(pt_metrics.GEN_SERVED)
            reg.observe(pt_metrics.TTFC_S, 0.5)

    ts = [threading.Thread(target=bump) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert reg.get(pt_metrics.GEN_SERVED) == 8000
    assert reg.histogram(pt_metrics.TTFC_S).count == 8000


# --------------------------------------------------------------------------- #
# stats tracker
# --------------------------------------------------------------------------- #


def _tracker_script(mod, seed):
    rng = np.random.default_rng(seed)
    t = mod.DistributedStatsTracker(name="ppo" if seed % 2 else "")
    out = []
    for step in range(3):
        n = int(rng.integers(3, 9))
        mask = rng.random(n) < 0.6
        with t.scope("actor"):
            t.denominator(n_tokens=mask, n_seqs=np.ones(n, bool))
            vals = (rng.integers(-64, 64, n) / 8).astype(np.float32)
            t.stat("n_tokens", loss=vals)
            t.stat("n_tokens", reduce_type=mod.ReduceType.SUM, tot=vals)
            t.stat("n_tokens", reduce_type=mod.ReduceType.MIN, lo=vals)
            t.stat("n_tokens", reduce_type=mod.ReduceType.MAX, hi=vals)
            t.stat("n_seqs", reduce_type=mod.ReduceType.AVG, all_avg=vals)
        t.scalar(lr=float(rng.integers(1, 9)) / 16)
        if step == 1:
            out.append(t.export(reset=False))
    out.append(t.export())
    out.append(t.export())          # reset: empty
    # an all-masked denominator exports 0 for MIN / MAX
    t.denominator(m=np.zeros(3, bool))
    t.stat("m", reduce_type=mod.ReduceType.MIN, x=np.ones(3))
    t.stat("m", reduce_type=mod.ReduceType.MAX, y=np.ones(3))
    out.append(t.export(cross_host=True))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stats_tracker_exports_match_the_reference(seed):
    assert _tracker_script(pt_stats, seed) == _tracker_script(ref_stats, seed)


def test_stats_tracker_rejects_what_the_reference_rejects():
    for mod in (pt_stats, ref_stats):
        t = mod.DistributedStatsTracker()
        t.denominator(m=np.ones(3, bool))
        with pytest.raises(ValueError):
            t.stat("m", v=np.ones(4))
        with pytest.raises(ValueError):
            t.stat("nope", v=np.ones(3))


def test_cross_host_reduce_over_a_gloo_world(tmp_path):
    """Two processes over ``torch.distributed`` (gloo): sums and counts
    add, extremes take the world's; with different keys it raises."""
    import subprocess
    import sys

    script = r"""
import sys, numpy as np, torch.distributed as dist
from areal_tpu_torch.base import stats_tracker as st
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + sys.argv[2],
                        rank=rank, world_size=2)
t = st.DistributedStatsTracker()
t.denominator(m=np.array([True, rank == 1, True]))
t.stat("m", v=np.array([1.0 + rank, 10.0, -rank], np.float32))
t.stat("m", reduce_type=st.ReduceType.MAX, hi=np.array([rank, 5.0, 0.0]))
t.scalar(s=float(rank))
print(sorted(t.export(cross_host=True).items()))
if rank == 1:
    t.scalar(extra=1.0)
t.scalar(s=0.0)
try:
    t.export(cross_host=True)
    print("no raise")
except RuntimeError as e:
    print("raised", "differ" in str(e))
dist.destroy_process_group()
"""
    import pathlib

    init = tmp_path / "init"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(init)],
        cwd=pathlib.Path(__file__).resolve().parents[1], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [o.strip().splitlines() for o, _ in outs]
    assert lines[0][0] == lines[1][0]
    got = dict(eval(lines[0][0]))
    # v: (1 + 0 + 0) from rank 0's two unmasked, (2 + 10 - 1) from rank 1
    assert got["v"] == pytest.approx((1 + 0 + 2 + 10 - 1) / 5)
    assert got["hi"] == 5.0 and got["m/n"] == 5.0
    assert got["s"] == pytest.approx(0.5)
    assert lines[0][1] == lines[1][1] == "raised True"
