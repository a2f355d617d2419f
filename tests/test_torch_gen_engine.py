"""Port parity: the generation engine and sampling of ``areal_tpu_torch``
against ``areal_tpu``.

Greedy output is compared TOKEN FOR TOKEN with the JAX engine on the
``tests/test_gen_engine.py`` config (float32, one param tree from a seed
fed to both): slot turnover, stop tokens, min/max tokens, an 8-way
shared-prefix group, pause -> resubmit, and the int8 pool. Logprobs agree
to 1e-4 (float32, accumulation order). Sampled rows cannot match JAX's
random bits, so they are held to the warped distribution by chi-square;
the warpers themselves match JAX exactly.
"""

import numpy as np
import pytest
from scipy import stats

import jax
import jax.numpy as jnp
import torch

from areal_tpu.gen import engine as jax_engine
from areal_tpu.gen import sampling as jax_sampling
from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu_torch.gen import engine as pt_engine
from areal_tpu_torch.gen import sampling as pt_sampling
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
ENGINE_KW = dict(max_slots=4, max_seqlen=128, page_size=8)
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


def _run(eng, module, reqs):
    for r in reqs:
        eng.submit(module.GenRequest(**r))
    return {o.rid: o for o in eng.run_until_done(decode_steps=STEPS)}


@pytest.fixture(scope="module")
def workload(tree):
    """11 requests over 4 slots: an 8-way group on one 21-token prompt
    (2 shared pages), a plain request, a stop-token request and a
    min-tokens request whose stop token would fire early."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 128, 21).tolist()
    p_plain = rng.integers(1, 128, 5).tolist()
    p_stop = rng.integers(1, 128, 7).tolist()
    p_min = rng.integers(1, 128, 9).tolist()
    pre = _run(_pt_engine(tree), pt_engine, [
        dict(rid="s", input_ids=p_stop, max_new_tokens=12, greedy=True),
        dict(rid="m", input_ids=p_min, max_new_tokens=12, greedy=True),
    ])
    reqs = [dict(rid=f"g{i}", input_ids=shared, max_new_tokens=6, greedy=True)
            for i in range(8)]
    reqs += [
        dict(rid="plain", input_ids=p_plain, max_new_tokens=10, greedy=True),
        dict(rid="stop", input_ids=p_stop, max_new_tokens=12, greedy=True,
             stop_token_ids=[pre["s"].output_ids[3]]),
        dict(rid="min", input_ids=p_min, max_new_tokens=12, greedy=True,
             min_new_tokens=4, stop_token_ids=[pre["m"].output_ids[1]]),
    ]
    return reqs


@pytest.fixture(scope="module")
def jax_outputs(tree, workload):
    out = {}
    for kv in ("raw", "int8"):
        eng = _jax_engine(tree, kv_dtype="int8" if kv == "int8" else None)
        out[kv] = (_run(eng, jax_engine, workload), dict(eng.stats),
                   eng.kv_pool_bytes())
    return out


@pytest.mark.parametrize("kv", ["raw", "int8"])
def test_greedy_token_exact_vs_jax_engine(tree, workload, jax_outputs, kv):
    want, want_stats, want_bytes = jax_outputs[kv]
    eng = _pt_engine(tree, kv_dtype="int8" if kv == "int8" else None)
    got = _run(eng, pt_engine, workload)
    assert set(got) == set(want)
    for rid, w in want.items():
        g = got[rid]
        assert g.output_ids == w.output_ids, rid
        assert g.finish_reason == w.finish_reason, rid
        np.testing.assert_allclose(g.output_logprobs, w.output_logprobs,
                                   atol=1e-4)
    assert got["stop"].finish_reason == "stop"
    assert len(got["min"].output_ids) >= 4
    assert all(got[f"g{i}"].output_ids == got["g0"].output_ids
               for i in range(8))
    for k in ("prefill_tokens", "prefix_hit_tokens", "prefix_hits",
              "admitted"):
        assert eng.stats[k] == want_stats[k], k
    assert eng.stats["prefix_hits"] > 0
    assert eng.kv_pool_bytes() == want_bytes
    # every page accounted for once the registry lets go
    eng.prefix.clear()
    assert eng.pool.n_free == eng.n_pages


def test_pause_resubmit_continues_the_same_tokens(tree, workload, jax_outputs):
    req = next(r for r in workload if r["rid"] == "plain")
    ref = jax_outputs["raw"][0]["plain"].output_ids
    eng = _pt_engine(tree)
    eng.submit(pt_engine.GenRequest(**req))
    eng.step(decode_steps=STEPS)
    partial = eng.partial_outputs()["plain"][0]
    parts = eng.pause()
    assert len(parts) == 1 and parts[0].finish_reason == "interrupted"
    got = parts[0].output_ids
    assert got == partial and 0 < len(got) < req["max_new_tokens"]
    assert eng.step() == []          # paused: nothing runs
    eng.resume()
    eng.submit(pt_engine.GenRequest(
        rid="plain2", input_ids=req["input_ids"] + got,
        max_new_tokens=req["max_new_tokens"] - len(got), greedy=True,
    ))
    rest = eng.run_until_done(decode_steps=STEPS)
    assert got + rest[0].output_ids == ref


def test_cancel_update_params_and_accounting(tree):
    eng = _pt_engine(tree, max_slots=2)
    eng.submit(pt_engine.GenRequest(rid="a", input_ids=[1, 2, 3],
                                    max_new_tokens=20, greedy=True))
    eng.submit(pt_engine.GenRequest(rid="b", input_ids=[4, 5, 6],
                                    max_new_tokens=3, greedy=True))
    eng.submit(pt_engine.GenRequest(rid="c", input_ids=[7, 8],
                                    max_new_tokens=3, greedy=True))
    assert eng.cancel("c")                        # still pending
    eng.step(decode_steps=2)
    assert eng.n_running() == 2 and eng.free_slots() == 0
    assert 0.0 < eng.kv_pool_occupancy() <= 1.0
    assert eng.cancel("a") and not eng.cancel("a")
    outs = eng.run_until_done(decode_steps=STEPS)
    assert [o.rid for o in outs] == ["b"] and outs[0].version == 0
    new = jax.tree.map(lambda a: a * 0.5, tree)
    eng.update_params(pt_tfm.params_from_numpy(new, device="cpu"), version=3)
    assert len(eng.prefix) == 0
    out = _run(eng, pt_engine, [dict(rid="d", input_ids=[1, 2, 3],
                                     max_new_tokens=2, greedy=True)])
    assert out["d"].version == 3
    assert eng.pool.n_free == eng.n_pages


def test_harvest_caches_output_pages_of_the_current_weights_only(tree):
    eng = _pt_engine(tree, max_slots=2)
    prompt = [3, 1, 4, 1, 5]
    (first,) = _run(eng, pt_engine, [dict(rid="a", input_ids=prompt,
                                          max_new_tokens=20,
                                          greedy=True)]).values()
    # 5 + 20 tokens hold KV for 24 positions: three full pages cached
    assert len(eng.prefix) == 3
    hits = eng.stats["prefix_hit_tokens"]
    ids = prompt + first.output_ids
    (again,) = _run(eng, pt_engine, [dict(rid="b", input_ids=ids,
                                          max_new_tokens=4,
                                          greedy=True)]).values()
    assert eng.stats["prefix_hit_tokens"] - hits == 3 * 8
    fresh = _run(_pt_engine(tree), pt_engine, [dict(
        rid="b", input_ids=ids, max_new_tokens=4, greedy=True)])
    assert again.output_ids == fresh["b"].output_ids
    # a slot that runs across an update holds KV of the old weights
    eng.submit(pt_engine.GenRequest(rid="c", input_ids=prompt,
                                    max_new_tokens=20, greedy=True))
    eng.step(decode_steps=STEPS)
    assert eng.n_running() == 1
    eng.update_params(pt_tfm.params_from_numpy(tree, device="cpu"))
    (late,) = eng.run_until_done(decode_steps=STEPS)
    assert late.rid == "c" and len(late.output_ids) == 20
    assert len(eng.prefix) == 0


def _option_kw(name, jax_outputs):
    if name == "max_new_tokens_cap":
        return dict(max_new_tokens_cap=5)
    if name == "stop_token_ids":
        # engine-wide: stops the plain request early, merged ahead of the
        # stop request's own
        return dict(stop_token_ids=[
            jax_outputs["raw"][0]["plain"].output_ids[2]])
    return dict(n_pages=12)     # a pool smaller than slots x table


@pytest.mark.parametrize("option", ["max_new_tokens_cap", "stop_token_ids",
                                    "n_pages"])
def test_engine_options_match_the_jax_engine(tree, workload, jax_outputs,
                                             option):
    """The engine options a launcher passes, held against the JAX engine
    built with the same value: tokens, finish reasons and the pool."""
    kw = _option_kw(option, jax_outputs)
    jeng, peng = _jax_engine(tree, **kw), _pt_engine(tree, **kw)
    want, got = _run(jeng, jax_engine, workload), _run(peng, pt_engine,
                                                      workload)
    assert set(got) == set(want)
    for rid, w in want.items():
        assert got[rid].output_ids == w.output_ids, rid
        assert got[rid].finish_reason == w.finish_reason, rid
    assert (peng.G, peng.n_pages, peng.global_stop_ids) == (
        jeng.G, jeng.n_pages, jeng.global_stop_ids)
    assert peng.kv_pool_bytes() == jeng.kv_pool_bytes()
    if option == "max_new_tokens_cap":
        assert max(len(o.output_ids) for o in got.values()) == 5
    elif option == "stop_token_ids":
        assert got["plain"].finish_reason == "stop"
        assert len(got["plain"].output_ids) == 3
    else:
        assert peng.n_pages == 12 and peng.pool.n_free + len(peng.prefix) <= 12


def test_submit_rejects_over_capacity(tree):
    eng = _pt_engine(tree)
    with pytest.raises(ValueError, match="per-slot capacity"):
        eng.submit(pt_engine.GenRequest(rid="x", input_ids=[1] * 120,
                                        max_new_tokens=20))


def test_kv_dtype_knob(tree, monkeypatch):
    monkeypatch.setenv("AREAL_KV_DTYPE", "int8")
    assert _pt_engine(tree).kv_quantized
    monkeypatch.setenv("AREAL_KV_DTYPE", "nonsense")
    assert not _pt_engine(tree).kv_quantized
    assert not _pt_engine(tree, kv_dtype="bf16").kv_quantized
    with pytest.raises(ValueError, match="unsupported kv_dtype"):
        _pt_engine(tree, kv_dtype="fp4")


# --------------------------------------------------------------------------- #
# sampling
# --------------------------------------------------------------------------- #


def _sp_pair(temp, top_p, top_k):
    j = jax_sampling.SamplingParams(
        temperature=jnp.asarray(temp, jnp.float32),
        top_p=jnp.asarray(top_p, jnp.float32),
        top_k=jnp.asarray(top_k, jnp.int32),
    )
    t = pt_sampling.SamplingParams(
        temperature=torch.tensor(temp, dtype=torch.float32),
        top_p=torch.tensor(top_p, dtype=torch.float32),
        top_k=torch.tensor(top_k, dtype=torch.int64),
    )
    return j, t


WARP_ROWS = dict(
    temp=[0.0, 1.0, 0.7, 1.3, 0.5, 1.0],
    top_p=[1.0, 0.9, 1.0, 0.5, 0.8, 1.0],
    top_k=[1 << 30, 1 << 30, 5, 3, 10, 1],
)


def test_warp_logits_exact_vs_jax():
    logits = np.random.default_rng(2).normal(size=(6, 50)).astype(np.float32) * 3
    jsp, tsp = _sp_pair(**WARP_ROWS)
    want = jax_sampling.warp_logits(jnp.asarray(logits), jsp)
    got = pt_sampling.warp_logits(torch.from_numpy(logits), tsp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_warp_logits_rows_exact_vs_jax():
    logits = np.random.default_rng(3).normal(size=(6, 50)).astype(np.float32) * 3
    jsp, tsp = _sp_pair(**WARP_ROWS)
    rows = np.asarray([1, 3, 4, 6], np.int32)     # 6 == B: padding, dropped
    want = jax_sampling.warp_logits_rows(jnp.asarray(logits), jsp,
                                         jnp.asarray(rows))
    got = pt_sampling.warp_logits_rows(torch.from_numpy(logits), tsp,
                                       torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("warp", [False, True])
def test_sample_tokens_distribution_and_logprobs(warp):
    """Sampled rows follow softmax(JAX-warped logits) (chi-square), greedy
    rows are the first-max argmax, and logprobs are the warped log-softmax
    at the token."""
    V, N = 12, 20000
    base = np.random.default_rng(4).normal(size=(V,)).astype(np.float32)
    logits = np.tile(base, (N, 1))
    temp = np.full(N, 0.8, np.float32)
    temp[:5] = 0.0                                  # greedy rows
    top_p = np.full(N, 0.9 if warp else 1.0, np.float32)
    top_k = np.full(N, 6 if warp else 1 << 30, np.int64)
    jsp, tsp = _sp_pair(temp, top_p, top_k)
    gen = torch.Generator().manual_seed(0)
    tokens, lp = pt_sampling.sample_tokens(
        gen, torch.from_numpy(logits), tsp, warp=warp,
    )
    tokens, lp = tokens.numpy(), lp.numpy()
    assert (tokens[:5] == np.argmax(base)).all()
    warped = (jax_sampling.warp_logits(jnp.asarray(logits[5:6]), jsp_row(jsp, 5))
              if warp else jnp.asarray(logits[5:6] / 0.8))
    probs = np.asarray(jax.nn.softmax(warped, axis=-1), np.float64)[0]
    counts = np.bincount(tokens[5:], minlength=V)
    kept = probs > 1e-6
    assert counts[~kept].sum() == 0
    chi = stats.chisquare(counts[kept], probs[kept] / probs[kept].sum()
                          * counts.sum())
    assert chi.pvalue > 1e-3, (counts, probs)
    want_lp = np.asarray(jax.nn.log_softmax(warped, axis=-1))[0][tokens[5:]]
    np.testing.assert_allclose(lp[5:], want_lp, atol=1e-5)


def jsp_row(jsp, i):
    return jax_sampling.SamplingParams(
        temperature=jsp.temperature[i : i + 1], top_p=jsp.top_p[i : i + 1],
        top_k=jsp.top_k[i : i + 1],
    )


# --------------------------------------------------------------------------- #
# fused sampling epilogue
# --------------------------------------------------------------------------- #


def test_fused_greedy_token_exact_vs_jax_fused_engine(tree, workload,
                                                      jax_outputs):
    """Both engines with ``fused_sample=True``: the same greedy tokens,
    and the unfused engines' tokens too (float32)."""
    jeng = _jax_engine(tree, fused_sample=True)
    want = _run(jeng, jax_engine, workload)
    eng = _pt_engine(tree, fused_sample=True)
    got = _run(eng, pt_engine, workload)
    assert eng.fused and jeng.fused
    for rid, w in want.items():
        assert got[rid].output_ids == w.output_ids, rid
        assert got[rid].finish_reason == w.finish_reason, rid
        np.testing.assert_allclose(got[rid].output_logprobs,
                                   w.output_logprobs, atol=1e-4)
        assert got[rid].output_ids == jax_outputs["raw"][0][rid].output_ids
    assert eng.stats["fused_sample_steps"] == eng.stats["decode_steps"] > 0
    assert eng.stats["fused_topk_steps"] == 0
    assert eng.stats["sampler_fallback_rows"] == 0


@pytest.mark.parametrize("raw,on", [("1", True), ("true", True), ("on", True),
                                    ("0", False), ("no", False), ("n", False),
                                    ("false", False), ("", False)])
def test_fused_sample_knob(tree, monkeypatch, raw, on):
    monkeypatch.setenv("AREAL_FUSED_SAMPLE", raw)
    assert _pt_engine(tree).fused is on
    assert _jax_engine(tree).fused is on
    # the explicit argument wins over the knob
    assert _pt_engine(tree, fused_sample=not on).fused is (not on)


def test_fused_sample_knob_default_off(tree, monkeypatch):
    monkeypatch.delenv("AREAL_FUSED_SAMPLE", raising=False)
    assert _pt_engine(tree).fused is False


def test_fused_mixed_batch_routes_rows_as_the_reference(tree):
    """greedy / temperature / top-p / top-k 20 / top-k 100 in one batch:
    the host mirrors match the JAX engine's, top-p and top-k 100 rows count
    as fallback rows, top-k 20 rides the online buffer, and the greedy
    request is exact whatever shares its batch."""
    reqs = [
        dict(rid="greedy", input_ids=[1, 2, 3, 4], max_new_tokens=8, greedy=True),
        dict(rid="temp", input_ids=[5, 2, 3, 4], max_new_tokens=8,
             temperature=0.8),
        dict(rid="top_p", input_ids=[6, 2, 3, 4], max_new_tokens=8, top_p=0.9),
        dict(rid="top_k20", input_ids=[7, 2, 3, 4], max_new_tokens=8, top_k=20),
        dict(rid="top_k100", input_ids=[8, 2, 3, 4], max_new_tokens=8,
             top_k=100),
    ]
    engines = {}
    for name, mod, make in (("pt", pt_engine, _pt_engine),
                            ("jax", jax_engine, _jax_engine)):
        eng = make(tree, max_slots=8, fused_sample=True)
        for r in reqs:
            eng.submit(mod.GenRequest(**r))
        eng.step(decode_steps=STEPS)
        engines[name] = eng
    pt, jx = engines["pt"], engines["jax"]
    for mirror in ("_warp_host", "_fused_warp_host", "_fused_topk_host"):
        np.testing.assert_array_equal(getattr(pt, mirror),
                                      getattr(jx, mirror), mirror)
    by_rid = {s.rid: b for b, s in enumerate(pt._slots) if s is not None}
    assert [bool(pt._fused_warp_host[by_rid[r["rid"]]]) for r in reqs] == [
        False, False, True, False, True]
    assert [bool(pt._fused_topk_host[by_rid[r["rid"]]]) for r in reqs] == [
        False, False, False, True, False]
    assert pt.stats["fused_sample_steps"] == STEPS
    assert pt.stats["fused_topk_steps"] == STEPS
    assert pt.stats["sampler_fallback_rows"] == 2 * STEPS
    outs = {o.rid: o for o in pt.run_until_done(decode_steps=STEPS)}
    assert pt.stats["sampler_fallback_rows"] == 2 * 8
    assert not pt._fused_warp_host.any() and not pt._fused_topk_host.any()
    alone = _run(_pt_engine(tree), pt_engine, reqs[:1])
    assert outs["greedy"].output_ids == alone["greedy"].output_ids
    for o in outs.values():
        assert len(o.output_ids) == 8
        assert np.isfinite(o.output_logprobs).all()
        assert (np.asarray(o.output_logprobs) <= 1e-6).all()
    # the same seed draws the same tokens again
    again = _pt_engine(tree, max_slots=8, fused_sample=True)
    outs2 = _run(again, pt_engine, reqs)
    assert {k: v.output_ids for k, v in outs2.items()} == {
        k: v.output_ids for k, v in outs.items()}


def test_fused_top_k_rows_stay_in_their_top_k(tree):
    """A top-k 2 request under the fused epilogue only ever emits one of
    the two likeliest tokens of the unfused logits at its position."""
    eng = _pt_engine(tree, fused_sample=True)
    out = _run(eng, pt_engine, [dict(rid="k", input_ids=[9, 8, 7, 6, 5],
                                     max_new_tokens=12, top_k=2)])["k"]
    cfg = PtConfig(**CFG_KW)
    params = pt_tfm.params_from_numpy(tree, device="cpu")
    ids = [9, 8, 7, 6, 5] + out.output_ids
    t = torch.tensor(ids)
    logits = pt_tfm.forward_packed(
        params, cfg, t, torch.ones(len(ids), dtype=torch.int32),
        torch.arange(len(ids), dtype=torch.int32), remat=False)
    for i, tok in enumerate(out.output_ids):
        top2 = torch.topk(logits[4 + i], 2).indices.tolist()
        assert tok in top2, (i, tok, top2)


def test_fused_pause_resume_keeps_the_prefix(tree, workload, jax_outputs):
    req = next(r for r in workload if r["rid"] == "plain")
    ref = jax_outputs["raw"][0]["plain"].output_ids
    eng = _pt_engine(tree, fused_sample=True)
    eng.submit(pt_engine.GenRequest(**req))
    eng.step(decode_steps=STEPS)
    (part,) = eng.pause()
    got = part.output_ids
    assert part.finish_reason == "interrupted" and got == ref[: len(got)]
    eng.resume()
    eng.submit(pt_engine.GenRequest(
        rid="plain2", input_ids=req["input_ids"] + got,
        max_new_tokens=req["max_new_tokens"] - len(got), greedy=True,
    ))
    rest = eng.run_until_done(decode_steps=STEPS)
    assert got + rest[0].output_ids == ref
