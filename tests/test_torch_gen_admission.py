"""Port parity: the generation engine's admission programs (extend and
commit, the counterparts of the reference's ``_jit_extend`` and
``_jit_commit``) and its admission options, ``areal_tpu_torch`` against
``areal_tpu``.

On the CPU an admission program is the eager body over the same static
buffers a GPU's CUDA graph reads (a wave's tokens, table rows, starts and
counts; a commit bucket's slot rows, padding rows aimed at the state's
trash row), so these tests exercise the aliasing a graph has. The config
is ``tests/test_torch_gen_engine.py``'s (float32, one param tree from a
seed fed to both engines). Greedy tokens must match the JAX engine's
exactly, and the two engines must have built the same programs: the
extend keys ``(n_rows, width, skip_pool)``, the commit buckets and
``n_compiles()``. The ports of ``tests/test_paged_engine.py::TestCapacity``
follow.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from areal_tpu.gen import engine as jax_engine
from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu_torch.gen import engine as pt_engine
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are tiny, so torch's intra-op thread pool buys nothing;
    one pool per test worker crowds out the timing-sensitive tests that
    other workers run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG_KW = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
              hidden_dim=32, intermediate_dim=64, vocab_size=128,
              dtype="float32")
# 12 slots: a burst of more than 8 arrivals fills two row buckets
ENGINE_KW = dict(max_slots=12, max_seqlen=128, page_size=8)
STEPS = 4


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(
        np.asarray, jax_tfm.init_params(JaxConfig(**CFG_KW), jax.random.key(5))
    )


def _pt_engine(tree, **kw):
    return pt_engine.GenerationEngine(
        PtConfig(**CFG_KW), pt_tfm.params_from_numpy(tree, device="cpu"),
        device="cpu", **{**ENGINE_KW, **kw},
    )


def _jax_engine(tree, **kw):
    return jax_engine.GenerationEngine(
        JaxConfig(**CFG_KW), jax.tree.map(jnp.asarray, tree),
        **{**ENGINE_KW, **kw},
    )


def _schedule():
    """Arrivals by engine step: a burst of 11 at step 0, then groups while
    decoding. Every prompt from one seed; greedy, no stop tokens."""
    rng = np.random.default_rng(7)

    def p(n):
        return rng.integers(1, 128, n).tolist()

    group = p(21)              # 2 full shared pages
    base = p(33)               # 4 full pages, cached cold ...
    partial = base[:16] + p(14)  # ... shares 2 of them, then diverges
    burst = [("c0", p(5), 6), ("c1", p(13), 9), ("base", base, 7),
             ("partial", partial, 8), ("long0", p(40), 6), ("long1", p(30), 10)]
    burst += [(f"g{i}", group, 5 + i) for i in range(5)]
    later = [("g5", group, 6), ("g6", group, 4), ("c2", p(9), 12),
             ("long2", p(57), 5)]
    last = [("partial2", partial, 6), ("c3", p(2), 7), ("c4", p(17), 8)]
    return {0: burst, 2: later, 5: last}


SCHEDULE = _schedule()


def _drive(eng, module, schedule=SCHEDULE, steps=STEPS):
    """Submit each arrival at its step, step through the schedule, then run
    until every request has finished."""
    outs = {}
    for i in range(max(schedule) + 1):
        for rid, ids, n in schedule.get(i, ()):
            eng.submit(module.GenRequest(rid=rid, input_ids=ids,
                                         max_new_tokens=n, greedy=True))
        outs.update({o.rid: o for o in eng.step(steps)})
    outs.update({o.rid: o for o in eng.run_until_done(decode_steps=steps)})
    return outs


def _assert_same_admission(peng, jeng, got, want):
    assert set(got) == set(want) == {
        rid for arrivals in SCHEDULE.values() for rid, _, _ in arrivals}
    for rid, w in want.items():
        assert got[rid].output_ids == w.output_ids, rid
        assert got[rid].finish_reason == w.finish_reason, rid
    assert set(peng._jit_extend) == set(jeng._jit_extend)
    assert set(peng._jit_commit) == set(jeng._jit_commit)
    assert set(peng._jit_chunk) == set(jeng._jit_chunk)
    assert peng.n_compiles() == jeng.n_compiles()
    for k in ("prefill_tokens", "prefix_hit_tokens", "prefix_hits",
              "admitted"):
        assert peng.stats[k] == jeng.stats[k], k


@pytest.fixture(scope="module")
def jax_runs(tree):
    cache = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in cache:
            jeng = _jax_engine(tree, **kw)
            cache[key] = (jeng, _drive(jeng, jax_engine))
        return cache[key]

    return get


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_admission_programs_and_tokens_equal_the_reference(tree, jax_runs,
                                                           pipelined, kv):
    """Staggered mixed traffic (cold prompts, a GRPO group that hits the
    prefix cache within its burst and later, a partial hit, multi-wave
    prompts, 11 arrivals at once), plain and pipelined, raw and int8
    pools: the same tokens, programs and prefill accounting as the JAX
    engine."""
    kw = dict(pipeline_chunks=pipelined, kv_dtype=kv)
    jeng, want = jax_runs(**kw)
    peng = _pt_engine(tree, **kw)
    fields = ("lens", "last_tokens", "active", "n_gen", "min_gen",
              "max_gen", "stop_ids", "out_tokens", "out_logprobs")
    ptrs = {f: getattr(peng.state, f).data_ptr() for f in fields}
    got = _drive(peng, pt_engine)
    _assert_same_admission(peng, jeng, got, want)
    # the commits wrote the state in place, through its padded rows
    assert {f: getattr(peng.state, f).data_ptr() for f in fields} == ptrs
    assert all(peng.state.padded[f].data_ptr() == ptrs[f] for f in fields)
    # the traffic reached every case it is meant to
    keys = set(peng._jit_extend)
    assert {8, 4} <= set(peng._jit_commit)          # two row buckets
    assert any(k[2] for k in keys) and any(not k[2] for k in keys)
    assert peng.stats["prefix_hits"] >= 8
    assert peng.stats["prefill_waves"] > len(keys)   # multi-wave prompts
    # on the CPU nothing is captured: every wave ran the eager body
    for k in ("extend_captures", "extend_replays", "commit_captures",
              "commit_replays"):
        assert peng.stats[k] == 0, k
    assert peng.stats["commit_waves"] >= 3
    assert not peng.has_inflight
    peng.prefix.clear()
    assert peng.pool.n_free == peng.n_pages


def test_partial_hit_registers_its_tail_after_the_waves(tree):
    """The partial hit borrows the two pages it shares with ``base`` and
    registers its own third page once the waves ran, so a later copy of
    it borrows three."""
    eng = _pt_engine(tree)
    burst = SCHEDULE[0]
    ids = {rid: p for rid, p, _ in burst}
    _drive(eng, pt_engine, {0: [a for a in burst
                                if a[0] in ("base", "partial")]})
    hits = eng.stats["prefix_hit_tokens"]
    assert hits == 16
    _drive(eng, pt_engine, {0: [("again", ids["partial"], 2)]})
    assert eng.stats["prefix_hit_tokens"] - hits == 24


@pytest.mark.parametrize("option,value", [
    ("admit_buckets", (1, 4)),
    ("enable_prefix_cache", False),
    ("admit_chunk_tokens", 300),
])
def test_admission_options_match_the_jax_engine(tree, jax_runs, option,
                                                value):
    """Each admission option against a JAX engine built with the same
    value: tokens, programs, prefill accounting."""
    jeng, want = jax_runs(**{option: value})
    peng = _pt_engine(tree, **{option: value})
    got = _drive(peng, pt_engine)
    _assert_same_admission(peng, jeng, got, want)
    assert peng.admit_buckets == list(jeng.admit_buckets)
    assert peng.admit_chunk == jeng.admit_chunk
    assert peng.enable_prefix_cache == jeng.enable_prefix_cache
    if option == "admit_buckets":
        # every burst commits in rows of 4 (11 = 4 + 4 + 3 padded)
        assert set(peng._jit_commit) == {4}
        assert {k[0] for k in peng._jit_extend} == {1, 4}
    elif option == "enable_prefix_cache":
        assert peng.stats["prefix_hits"] == 0 and len(peng.prefix) == 0
        assert peng.pool.n_free == peng.n_pages
    else:
        # rounded up to whole pages: every prompt fits one wave, whose
        # static tokens are [n_rows, 304]
        assert peng.admit_chunk == 304
        for key in peng._jit_extend:
            tokens, table, start, n_new = peng._extend_operands(key)
            assert tokens.shape == (key[0], 304)
            assert table.shape == (key[0], key[1])
        assert peng._extend_ops.numel() == 8 * (304 + peng.M + 2)


def test_weight_update_admits_through_the_same_extend_programs(tree):
    """An extend key built before ``update_params`` serves admissions after
    it: the programs read the engine's tensors, which the update copies
    into, and the tokens equal a fresh engine's on the new weights."""
    half = jax.tree.map(lambda a: a * 0.5, tree)
    prompt = SCHEDULE[0][4][1]          # long0: 5 waves
    req = dict(rid="x", input_ids=prompt, max_new_tokens=8, greedy=True)
    eng = _pt_engine(tree)
    before = _drive(eng, pt_engine, {0: [("x", prompt, 8)]})["x"]
    keys = dict(eng._jit_extend)
    eng.update_params(pt_tfm.params_from_numpy(half, device="cpu"))
    after = _drive(eng, pt_engine, {0: [("x", prompt, 8)]})["x"]
    assert eng._jit_extend == keys
    fresh = _pt_engine(half)
    fresh.submit(pt_engine.GenRequest(**req))
    (want,) = fresh.run_until_done(decode_steps=STEPS)
    assert after.output_ids == want.output_ids
    assert after.output_ids != before.output_ids
    # the update dropped the prefix cache: the prompt was prefilled again
    assert eng.stats["prefix_hit_tokens"] == 0


# ports of tests/test_paged_engine.py::TestCapacity


def test_small_pool_defers_admission(tree):
    """A pool smaller than slots x capacity admits what fits and keeps the
    rest pending instead of crashing."""
    eng = _pt_engine(tree, max_slots=4, max_seqlen=64, n_pages=6,
                     enable_prefix_cache=False)
    # each request needs ceil((7+16)/8) = 3 pages -> only 2 fit
    for i in range(4):
        eng.submit(pt_engine.GenRequest(
            rid=f"r{i}", input_ids=list(range(1, 9)), max_new_tokens=16,
            greedy=True,
        ))
    eng.step(decode_steps=1)
    assert eng.n_running() == 2 and eng.n_pending() == 2
    outs = eng.run_until_done(decode_steps=8)   # turnover drains the rest
    assert len(outs) == 4
    assert eng.pool.n_free == 6


def test_compile_count_stable_across_mixed_workload(tree, rng):
    """Programs are bounded by admit-row buckets and the decode chunk, not
    by prompt lengths (chunked prefill removes the length dimension)."""
    eng = _pt_engine(tree, max_slots=4, max_seqlen=256, page_size=16)
    for i, plen in enumerate([3, 9, 17, 33, 65, 100, 130, 7, 55, 23]):
        eng.submit(pt_engine.GenRequest(
            rid=f"m{i}",
            input_ids=[int(x) for x in rng.integers(1, 128, plen)],
            max_new_tokens=4, greedy=True,
        ))
    eng.run_until_done(decode_steps=4)
    # warm every admit-row bucket with varying arrival counts
    for n_batch in (1, 2, 3, 4):
        for i in range(n_batch):
            eng.submit(pt_engine.GenRequest(
                rid=f"w{n_batch}-{i}",
                input_ids=[int(x) for x in rng.integers(1, 128, 40)],
                max_new_tokens=4, greedy=True,
            ))
        eng.run_until_done(decode_steps=4)
    warmed = eng.n_compiles()
    # hard bound: up to two extends per bucket (cold-prompt skip-pool
    # variant + pool variant) + one commit per bucket + one decode chunk
    assert warmed <= 3 * len(eng.admit_buckets) + 1
    # fresh prompt lengths never trigger new programs
    for i, plen in enumerate([11, 29, 77, 128, 201]):
        eng.submit(pt_engine.GenRequest(
            rid=f"n{i}",
            input_ids=[int(x) for x in rng.integers(1, 128, plen)],
            max_new_tokens=4, greedy=True,
        ))
    eng.run_until_done(decode_steps=4)
    assert eng.n_compiles() == warmed
