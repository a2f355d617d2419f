"""Port parity: the generation engine's chunk programs and pipelined
harvest (``pipeline_chunks`` / ``AREAL_DECODE_PIPELINE``) of
``areal_tpu_torch`` against ``areal_tpu``.

On the CPU a chunk program is the eager chunk body over the same static
buffers a GPU's CUDA graph reads and writes (state updated in place, a
fixed page table, warp-row and flag buffer), so these tests exercise the
aliasing the graph has: a harvest that read the static flags after the
next chunk ran would see that chunk's flags. The config is
``tests/test_torch_gen_engine.py``'s (float32, one param tree from a seed
fed to both engines); greedy tokens must match the JAX engine's exactly
and logprobs to 1e-4 (float32, accumulation order). The ports of
``tests/test_gen_engine.py::TestPipelinedChunks``,
``tests/test_paged_engine.py`` (bounded compiles) and
``tests/test_fused_sample.py`` (fused bounded compiles) follow.
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


def _run(eng, module, reqs, steps=STEPS):
    for r in reqs:
        eng.submit(module.GenRequest(**r))
    return {o.rid: o for o in eng.run_until_done(decode_steps=steps)}


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, n).tolist() for n in lens]


# four requests over four slots finishing at different chunks, and three
# sharing one 17-token prompt (two shared pages)
GREEDY = (
    [dict(rid=f"r{i}", input_ids=p, max_new_tokens=10 + i, greedy=True)
     for i, p in enumerate(_prompts(0, (5, 9, 3, 7)))]
    + [dict(rid=f"g{i}", input_ids=_prompts(1, (17,))[0],
            max_new_tokens=6 + 3 * i, greedy=True) for i in range(3)]
)


@pytest.fixture(scope="module")
def jax_pipelined():
    """The JAX engine with ``pipeline_chunks=True`` on GREEDY, plain and
    fused: outputs and chunk-program keys."""
    cache = {}

    def get(tree, fused):
        if fused not in cache:
            eng = _jax_engine(tree, pipeline_chunks=True, fused_sample=fused)
            cache[fused] = _run(eng, jax_engine, GREEDY)
        return cache[fused]

    return get


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_greedy_token_exact_vs_jax_pipelined_engine(tree, jax_pipelined,
                                                    fused, pipelined):
    want = jax_pipelined(tree, fused)
    eng = _pt_engine(tree, pipeline_chunks=pipelined, fused_sample=fused)
    fields = ("lens", "last_tokens", "active", "n_gen", "out_tokens",
              "out_logprobs")
    ptrs = {f: getattr(eng.state, f).data_ptr() for f in fields}
    got = _run(eng, pt_engine, GREEDY)
    # the chunks updated the state in place: a graph replays into these
    # very tensors, so a body that rebound one would decode into nowhere
    assert {f: getattr(eng.state, f).data_ptr() for f in fields} == ptrs
    assert set(got) == set(want)
    for rid, w in want.items():
        assert got[rid].output_ids == w.output_ids, rid
        assert got[rid].finish_reason == w.finish_reason, rid
        np.testing.assert_allclose(got[rid].output_logprobs,
                                   w.output_logprobs, atol=1e-4)
    assert not eng.has_inflight
    # every dispatched chunk was resolved once; none waited on the CPU
    assert eng.stats["chunk_flag_fetches"] == eng._n_dispatched > 0
    assert eng.stats["chunk_flag_blocked"] == 0
    assert eng.stats["graph_captures"] == eng.stats["graph_replays"] == 0
    eng.prefix.clear()
    assert eng.pool.n_free == eng.n_pages


def test_pipelined_staggered_admission(tree):
    """Five requests through two slots, admitted mid-flight as late
    harvests free slots: a fresh slot's state must not be clobbered by the
    previous chunk's stale flags, and every token matches the JAX
    engine's."""
    reqs = [dict(rid=f"s{i}", input_ids=p, max_new_tokens=6, greedy=True)
            for i, p in enumerate(_prompts(2, (4, 5, 6, 7, 8)))]
    kw = dict(max_slots=2, max_seqlen=64, pipeline_chunks=True)
    want = _run(_jax_engine(tree, **kw), jax_engine, reqs, steps=3)
    got = _run(_pt_engine(tree, **kw), pt_engine, reqs, steps=3)
    assert set(got) == set(want) == {f"s{i}" for i in range(5)}
    for rid, w in want.items():
        assert got[rid].output_ids == w.output_ids, rid
        assert len(got[rid].output_ids) == 6


def test_pause_classifies_unharvested_finishes(tree):
    """A slot that FINISHED in the in-flight chunk comes out of pause() as
    stop/length, not interrupted (a client would resubmit a complete
    sample)."""
    results = {}
    for name, mod, make in (("pt", pt_engine, _pt_engine),
                            ("jax", jax_engine, _jax_engine)):
        eng = make(tree, max_slots=2, max_seqlen=64, pipeline_chunks=True)
        eng.submit(mod.GenRequest(rid="short", input_ids=[3, 4, 5],
                                  max_new_tokens=2, greedy=True))
        eng.submit(mod.GenRequest(rid="long", input_ids=[6, 7, 8],
                                  max_new_tokens=40, greedy=True))
        # one step dispatches a 4-step chunk; "short" finishes inside it
        # on the device but its harvest is deferred
        assert eng.step(decode_steps=4) == []
        assert eng.has_inflight
        results[name] = {o.rid: o for o in eng.pause()}
        assert not eng.has_inflight and eng.n_running() == 0
    got, want = results["pt"], results["jax"]
    assert got["short"].finish_reason == "length"
    assert len(got["short"].output_ids) == 2
    assert got["long"].finish_reason == "interrupted"
    for rid in ("short", "long"):
        assert got[rid].output_ids == want[rid].output_ids, rid
        assert got[rid].finish_reason == want[rid].finish_reason, rid


def test_cancel_with_a_chunk_in_flight(tree):
    """Cancel a slot while a pipelined chunk holds it, then admit a new
    request into the freed slot before that chunk's flags are read: the
    stale flags skip both, and the survivor and the newcomer decode as
    they do alone."""
    p_a, p_b, p_c = _prompts(3, (5, 6, 7))
    eng = _pt_engine(tree, max_slots=2, pipeline_chunks=True)
    eng.submit(pt_engine.GenRequest(rid="a", input_ids=p_a,
                                    max_new_tokens=30, greedy=True))
    eng.submit(pt_engine.GenRequest(rid="b", input_ids=p_b,
                                    max_new_tokens=9, greedy=True))
    assert eng.step(decode_steps=STEPS) == [] and eng.has_inflight
    assert eng.cancel("a") and not eng.cancel("a")
    eng.submit(pt_engine.GenRequest(rid="c", input_ids=p_c,
                                    max_new_tokens=5, greedy=True))
    outs = {o.rid: o for o in eng.run_until_done(decode_steps=STEPS)}
    assert set(outs) == {"b", "c"}
    for rid, p, n in (("b", p_b, 9), ("c", p_c, 5)):
        (alone,) = _run(_pt_engine(tree), pt_engine, [
            dict(rid=rid, input_ids=p, max_new_tokens=n, greedy=True)
        ]).values()
        assert outs[rid].output_ids == alone.output_ids, rid
        assert outs[rid].finish_reason == "length"
    eng.prefix.clear()
    assert eng.pool.n_free == eng.n_pages


def test_flags_are_snapshot_before_the_next_chunk(tree):
    """The static flag buffer is the chunk programs' one output: once the
    next chunk is dispatched it holds THAT chunk's flags, and a chunk
    resolves to the copy taken right behind it at dispatch."""
    eng = _pt_engine(tree, max_slots=2, pipeline_chunks=True)
    eng.submit(pt_engine.GenRequest(rid="a", input_ids=[1, 2, 3],
                                    max_new_tokens=20, greedy=True))
    eng.step(decode_steps=STEPS)
    first = eng._inflight
    eng.step(decode_steps=STEPS)          # dispatches chunk 2, resolves 1
    assert eng._inflight is not first
    assert eng._flags_dev[1, 0] == 2 * STEPS      # n_gen after chunk 2
    assert eng._resolve(first)[1, 0] == STEPS     # ... after chunk 1
    eng.pause()


# mixed traffic: greedy, temperature, top-p, top-k 8 (online buffer under
# the fused sampler) and top-k 100 (past the buffer: sorted fallback); no
# stop tokens, so every request runs to its length and the schedule, and
# with it the chunk keys, is the same whatever is sampled
MIXED = [
    dict(rid="g", input_ids=[1, 2, 3, 4], max_new_tokens=12, greedy=True),
    dict(rid="t", input_ids=[5, 2, 3, 4, 9], max_new_tokens=9,
         temperature=0.8),
    dict(rid="p", input_ids=[6, 2, 3], max_new_tokens=7, top_p=0.9),
    dict(rid="k", input_ids=[7, 2, 3, 4, 5, 6], max_new_tokens=10, top_k=8),
    dict(rid="k100", input_ids=[8, 2], max_new_tokens=5, top_k=100),
    dict(rid="g2", input_ids=list(range(1, 40)), max_new_tokens=6,
         greedy=True),
]


@pytest.mark.parametrize("fused", [False, True])
def test_chunk_program_keys_equal_the_reference(tree, fused):
    """After the same traffic the port holds one chunk program per key of
    the reference's ``_jit_chunk``, and the same greedy tokens."""
    jeng = _jax_engine(tree, fused_sample=fused)
    want = _run(jeng, jax_engine, MIXED)
    eng = _pt_engine(tree, fused_sample=fused)
    got = _run(eng, pt_engine, MIXED)
    assert set(eng._jit_chunk) == set(jeng._jit_chunk)
    assert set(eng._jit_extend) == set(jeng._jit_extend)
    assert set(eng._jit_commit) == set(jeng._jit_commit)
    assert eng.n_compiles() == jeng.n_compiles() > len(jeng._jit_chunk) > 1
    assert {k[3] for k in eng._jit_chunk} == {fused}
    if fused:
        assert any(k[4] for k in eng._jit_chunk)   # the online top-k buffer
    assert any(k[2] for k in eng._jit_chunk)       # a warp-row bucket
    for rid in ("g", "g2"):
        assert got[rid].output_ids == want[rid].output_ids, rid
    assert {r: len(o.output_ids) for r, o in got.items()} == {
        r["rid"]: r["max_new_tokens"] for r in MIXED}


@pytest.mark.parametrize("fused", [False, True])
def test_n_compiles_stable_across_prompt_lengths(tree, fused):
    """Warm greedy, top-p and top-k traffic, then the same kinds at new
    prompt lengths: no new chunk program (the keys carry table-width and
    warp-row buckets, never a prompt length)."""
    eng = _pt_engine(tree, fused_sample=fused, max_seqlen=256, page_size=16)
    rng = np.random.default_rng(4)

    def burst(tag, plens, **req_kw):
        for i, plen in enumerate(plens):
            eng.submit(pt_engine.GenRequest(
                rid=f"{tag}{i}", input_ids=rng.integers(1, 128, plen).tolist(),
                max_new_tokens=6, **req_kw,
            ))
        eng.run_until_done(decode_steps=3)

    burst("g", [3, 9, 17, 33], greedy=True)
    burst("p", [3, 9], temperature=1.0, top_p=0.9)
    burst("k", [5, 21], temperature=1.0, top_k=8)
    warmed = eng.n_compiles()
    burst("g2", [11, 29, 60], greedy=True)
    burst("p2", [7, 45], temperature=1.0, top_p=0.9)
    burst("k2", [13, 80], temperature=1.0, top_k=8)
    assert eng.n_compiles() == warmed


@pytest.mark.parametrize("raw,on", [("1", True), ("on", True), ("0", False),
                                    ("", False)])
def test_decode_pipeline_knob(tree, monkeypatch, raw, on):
    monkeypatch.setenv("AREAL_DECODE_PIPELINE", raw)
    assert _pt_engine(tree).pipeline is on
    assert _jax_engine(tree)._pipeline is on
    # the explicit argument wins over the knob
    assert _pt_engine(tree, pipeline_chunks=not on).pipeline is (not on)
    monkeypatch.delenv("AREAL_DECODE_PIPELINE")
    assert _pt_engine(tree).pipeline is False


def _score(params, ids, n_prompt):
    """Log-softmax of ``params``' logits at each generated token of ``ids``
    (temperature 1): what a sampled request's logprobs must be."""
    t = torch.tensor(ids)
    logits = pt_tfm.forward_packed(
        params, PtConfig(**CFG_KW), t, torch.ones(len(ids), dtype=torch.int32),
        torch.arange(len(ids), dtype=torch.int32), remat=False)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return np.asarray([float(lp[n_prompt - 1 + i, tok])
                       for i, tok in enumerate(ids[n_prompt:])])


def test_update_params_copies_into_the_engine_tensors(tree):
    """A weight update lands in the tensors the chunk programs read (a CUDA
    graph keeps their addresses): a sampled request's logprobs after it
    are the new weights' and not the old ones' (greedy logprobs are 0 at
    the temperature floor, so they cannot tell). The engine never aliases
    its caller's tensors, and a wrong shape raises, changing nothing."""
    params = pt_tfm.params_from_numpy(tree, device="cpu")
    eng = pt_engine.GenerationEngine(PtConfig(**CFG_KW), params,
                                     device="cpu", **ENGINE_KW)
    wq = eng.params["layers"][0]["attn"]["wq"]
    assert wq.data_ptr() != params["layers"][0]["attn"]["wq"].data_ptr()
    prompt = [1, 2, 3, 4]
    req = dict(rid="x", input_ids=prompt, max_new_tokens=8, temperature=1.0)
    _run(eng, pt_engine, [req])             # builds the chunk program
    half = jax.tree.map(lambda a: a * 0.5, tree)
    new = pt_tfm.params_from_numpy(half, device="cpu")
    eng.update_params(new, version=2)
    assert eng.params["layers"][0]["attn"]["wq"] is wq
    torch.testing.assert_close(wq, new["layers"][0]["attn"]["wq"],
                               rtol=0, atol=0)
    after = _run(eng, pt_engine, [req])["x"]
    # nothing was rebuilt for the new weights: one chunk, one extend and
    # one commit program read them
    assert after.version == 2 and eng.n_compiles() == 3
    assert len(eng._jit_chunk) == len(eng._jit_extend) == 1
    assert list(eng._jit_commit) == [1]
    ids = prompt + after.output_ids
    np.testing.assert_allclose(after.output_logprobs,
                               _score(new, ids, len(prompt)), atol=1e-4)
    stale = _score(params, ids, len(prompt))
    assert np.abs(np.asarray(after.output_logprobs) - stale).max() > 1e-2
    bad = pt_tfm.params_from_numpy(tree, device="cpu")
    bad["layers"][1]["attn"]["wq"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        eng.update_params(bad)
    assert eng.version == 2
    torch.testing.assert_close(wq, new["layers"][0]["attn"]["wq"],
                               rtol=0, atol=0)
