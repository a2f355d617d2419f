"""Port parity: speculative decoding in ``areal_tpu_torch`` against
``areal_tpu`` (the counterpart of ``tests/test_spec_decode.py``).

The config is ``tests/test_spec_decode.py``'s tiny float32 model; one JAX
param tree from a seed feeds both packages (``params_from_numpy``), and
the port runs with ``device="cpu"`` (its chunk programs run eagerly there
over the same static buffers a GPU's CUDA graphs read and write). Held
against the JAX package on the same inputs:

- ``NGramDrafter.propose``: exactly;
- ``verify_step_paged``: logits within 1e-4 of the JAX function's on one
  pool and table, and of K+1 sequential ``decode_step_paged`` calls;
- ``spec_rejection_sample`` (one-hot and general-q) and
  ``fused_spec_rejection``: greedy rows' accept lengths and tokens
  exactly, logprobs within 1e-5; the first emitted token's marginal
  against the target by chi-square (the port's own draws);
- spec engines (n-gram and shared-prefix draft model, pipelined and not,
  K 1 and 4, the fused sampler, stop tokens mid-draft, min_new_tokens):
  the JAX engines' greedy tokens exactly, logprobs within 1e-4; spec
  program keys after mixed spec / vanilla traffic equal to ``_jit_spec``;
- composition: pause mid spec chunk, weight and draft-weight swaps, draft
  pages in lockstep, adaptive K, the drafter checks.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from areal_tpu.gen import drafter as jax_drafter
from areal_tpu.gen import engine as jax_engine
from areal_tpu.gen import sampling as jax_sampling
from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu.ops import fused_sample as jax_fused
from areal_tpu_torch.base import constants
from areal_tpu_torch.gen import drafter as pt_drafter
from areal_tpu_torch.gen import engine as pt_engine
from areal_tpu_torch.gen import sampling as pt_sampling
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig
from areal_tpu_torch.ops import fused_sample as pt_fused


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
LP_ATOL = 1e-4      # float32 engines: accumulation order only


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(
        np.asarray, jax_tfm.init_params(JaxConfig(**CFG_KW), jax.random.key(5))
    )


def _drafter(module, cfg, params, kind):
    if kind == "draft":
        return module.TransformerDrafter.shared_prefix(cfg, params, 1)
    return None


def _pt_engine(tree, kind="ngram", **kw):
    cfg = PtConfig(**CFG_KW)
    params = pt_tfm.params_from_numpy(tree, device="cpu")
    return pt_engine.GenerationEngine(
        cfg, params, drafter=_drafter(pt_drafter, cfg, params, kind),
        device="cpu", **{**ENGINE_KW, **kw},
    )


def _jax_engine(tree, kind="ngram", **kw):
    cfg = JaxConfig(**CFG_KW)
    params = jax.tree.map(jnp.asarray, tree)
    return jax_engine.GenerationEngine(
        cfg, params, drafter=_drafter(jax_drafter, cfg, params, kind),
        **{**ENGINE_KW, **kw},
    )


def _run(eng, module, reqs, steps):
    for r in reqs:
        eng.submit(module.GenRequest(**r))
    return {o.rid: o for o in eng.run_until_done(decode_steps=steps)}


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, n).tolist() for n in lens]


def _motif_prompt(seed, n, motif_len=5):
    """A repetitive prompt (a motif repeated): the n-gram drafter's case."""
    motif = np.random.default_rng(seed).integers(1, 128, motif_len).tolist()
    return (motif * (n // motif_len + 1))[:n]


# three random prompts and one repetitive one, finishing at different chunks
GREEDY = [
    dict(rid=f"r{i}", input_ids=p, max_new_tokens=10 + 3 * i, greedy=True)
    for i, p in enumerate(_prompts(0, (5, 9, 3)) + [_motif_prompt(1, 23)])
]


def _assert_same(got, want):
    assert set(got) == set(want)
    for rid, w in want.items():
        assert got[rid].output_ids == w.output_ids, rid
        assert got[rid].finish_reason == w.finish_reason, rid
        np.testing.assert_allclose(got[rid].output_logprobs,
                                   w.output_logprobs, atol=LP_ATOL)


# --------------------------------------------------------------------------- #
# the n-gram drafter
# --------------------------------------------------------------------------- #


def _propose_both(ctx, lens, fallback, k):
    want = jax_drafter.NGramDrafter().propose(
        jnp.asarray(ctx, jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.asarray(fallback, jnp.int32), k)
    got = pt_drafter.NGramDrafter().propose(
        torch.tensor(ctx, dtype=torch.int64),
        torch.tensor(lens, dtype=torch.int32),
        torch.tensor(fallback, dtype=torch.int64), k)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_ngram_propose_equals_jax(k):
    """Seeded contexts over a small alphabet (many bigram and unigram
    matches), rows of unique tokens (no match: the fallback), lens 0 and
    the last column (continuations at the edge of the valid region)."""
    rng = np.random.default_rng(k)
    B, S = 24, 40
    ctx = rng.integers(0, 6, size=(B, S))
    ctx[:4] = np.arange(100, 100 + S)          # no earlier occurrence
    lens = rng.integers(0, S, size=B)
    lens[[0, 4, 8]] = 0
    lens[[1, 5, 9]] = S - 1
    lens[[2, 6]] = 1
    fallback = rng.integers(50, 60, size=B)
    got, want = _propose_both(ctx, lens, fallback, k)
    np.testing.assert_array_equal(got, want)
    assert (got[:4] == fallback[:4, None]).all()


def test_ngram_reference_cases():
    """``tests/test_spec_decode.py::TestNGramDrafter``'s three contexts:
    a bigram match, the unigram fallback then the hint, and proposals that
    never cross the valid region."""
    cases = [
        ([[1, 2, 3, 4, 1, 2, 0, 0]], [5], [99], 3, [3, 4, 1]),
        ([[1, 2, 3, 4, 5, 2, 0, 0]], [5], [99], 3, [3, 4, 5]),
        ([[1, 2, 3, 4, 5, 6, 0, 0]], [5], [99], 2, [99, 99]),
        ([[0, 1, 2, 1, 2, 7, 7, 7]], [4], [50], 4, [1, 2, 50, 50]),
    ]
    for ctx, lens, fb, k, want in cases:
        got, ref = _propose_both(ctx, lens, fb, k)
        assert got[0].tolist() == ref[0].tolist() == want


# --------------------------------------------------------------------------- #
# the verify pass
# --------------------------------------------------------------------------- #


def test_verify_step_matches_jax_and_sequential_decode(tree):
    """One pool, one table: the port's verify logits within 1e-4 of the
    JAX function's, the pools alike after the masked scatter, and each
    position's logits within 1e-4 of K+1 sequential teacher-forced
    ``decode_step_paged`` calls."""
    rng = np.random.default_rng(7)
    cfg_j, cfg_p = JaxConfig(**CFG_KW), PtConfig(**CFG_KW)
    L, Hkv, D, page, P, W = 2, 2, 8, 8, 24, 5
    B, C = 3, 4
    pages = rng.normal(size=(L, P, 2, Hkv, page, D)).astype(np.float32)
    table = rng.permutation(P)[: B * W].reshape(B, W).astype(np.int32)
    lens = np.array([13, 0, 22], np.int32)
    tokens = rng.integers(1, 128, size=(B, C)).astype(np.int32)
    active = np.array([True, True, False])
    n_new = np.where(active, C, 0).astype(np.int32)
    write = active[:, None] & (np.arange(C)[None, :] < np.array(
        [[C], [2], [C]]))
    want, jcache = jax_tfm.verify_step_paged(
        jax.tree.map(jnp.asarray, tree), cfg_j,
        jax_tfm.PagedKVCache(pages=jnp.asarray(pages)), jnp.asarray(tokens),
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(n_new),
        jnp.asarray(write))
    params = pt_tfm.params_from_numpy(tree, device="cpu")
    cache = pt_tfm.PagedKVCache.from_pages(torch.from_numpy(pages))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    got, cache = pt_tfm.verify_step_paged(
        params, cfg_p, cache, t(tokens).long(), t(table), t(lens),
        t(n_new), t(write))
    np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active],
                               atol=1e-4)
    np.testing.assert_allclose(cache.pages.numpy(), np.asarray(jcache.pages),
                               atol=1e-5)

    # sequential decode over the same tokens from the original pool
    seq = pt_tfm.PagedKVCache.from_pages(torch.from_numpy(pages))
    lens_t = t(lens)
    act = torch.from_numpy(active)
    for i in range(C):
        logits, seq, lens_t = pt_tfm.decode_step_paged(
            params, cfg_p, seq, t(tokens[:, i]).long(), t(table), lens_t,
            act)
        np.testing.assert_allclose(got[:, i].numpy()[active],
                                   logits.numpy()[active], atol=1e-4)
    hidden, _ = pt_tfm.verify_step_paged(
        params, cfg_p, pt_tfm.PagedKVCache.from_pages(torch.from_numpy(pages)),
        t(tokens).long(), t(table), t(lens), t(n_new), t(write),
        return_hidden=True)
    np.testing.assert_allclose(
        pt_tfm.apply_head(cfg_p, params, hidden).numpy()[active],
        got.numpy()[active], atol=1e-5)


def test_headless_decode_step_writes_the_same_kv(tree):
    """``decode_step_paged(with_head=False)`` returns no logits and leaves
    the pool and lens exactly as the full step does."""
    params = pt_tfm.params_from_numpy(tree, device="cpu")
    cfg = PtConfig(**CFG_KW)
    rng = np.random.default_rng(3)
    pages = torch.from_numpy(
        rng.normal(size=(2, 8, 2, 2, 8, 8)).astype(np.float32))
    args = (torch.tensor([5, 9]), torch.tensor([[0, 1], [2, 3]],
                                               dtype=torch.int32),
            torch.tensor([3, 12], dtype=torch.int32),
            torch.tensor([True, False]))
    full = pt_tfm.decode_step_paged(
        params, cfg, pt_tfm.PagedKVCache.from_pages(pages), *args)
    bare = pt_tfm.decode_step_paged(
        params, cfg, pt_tfm.PagedKVCache.from_pages(pages), *args,
        with_head=False)
    assert bare[0] is None and full[0].shape == (2, 128)
    assert torch.equal(bare[1].flat, full[1].flat)
    assert torch.equal(bare[2], full[2])


# --------------------------------------------------------------------------- #
# rejection sampling
# --------------------------------------------------------------------------- #


def _sp_pair(temps, top_p=None, top_k=None):
    n = len(temps)
    top_p = np.ones(n, np.float32) if top_p is None else np.asarray(top_p)
    top_k = np.full(n, 1 << 30) if top_k is None else np.asarray(top_k)
    jsp = jax_sampling.SamplingParams(
        temperature=jnp.asarray(temps, jnp.float32),
        top_p=jnp.asarray(top_p, jnp.float32),
        top_k=jnp.asarray(top_k, jnp.int32))
    psp = pt_sampling.SamplingParams(
        temperature=torch.tensor(temps, dtype=torch.float32),
        top_p=torch.tensor(top_p, dtype=torch.float32),
        top_k=torch.tensor(top_k, dtype=torch.int64))
    return jsp, psp


def _greedy_case(seed, B=8, K=3, V=32):
    """Logits with clear argmaxes and drafts that follow each row's argmax
    chain for 0..K positions, then diverge."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, K + 1, V)).astype(np.float32) * 3
    arg = logits.argmax(-1)
    draft = rng.integers(0, V, size=(B, K))
    for b in range(B):
        n_match = b % (K + 1)
        draft[b, :n_match] = arg[b, :n_match]
        if n_match < K:
            draft[b, n_match] = (arg[b, n_match] + 1) % V
    return logits, draft.astype(np.int32)


@pytest.mark.parametrize("general_q", [False, True])
@pytest.mark.parametrize("warp", ["plain", "rows", "multi"])
def test_greedy_rejection_equals_jax(general_q, warp):
    """Greedy rows: accept lengths, tokens and boundary argmax exactly the
    JAX function's, logprobs within 1e-5, for the one-hot and the general-q
    branch and each warp mode (top-p / top-k rows beside greedy ones keep
    greedy rows exact)."""
    logits, draft = _greedy_case(11)
    B, C, V = logits.shape
    temps = np.zeros(B, np.float32)
    top_p = np.where(np.arange(B) % 2, 0.7, 1.0).astype(np.float32)
    top_k = np.where(np.arange(B) % 3 == 0, 5, 1 << 30)
    jsp, psp = _sp_pair(temps, top_p, top_k)
    q = None
    if general_q:
        q = np.asarray(jax.nn.log_softmax(jnp.asarray(
            np.random.default_rng(2).normal(size=(B, C - 1, V)),
            jnp.float32), axis=-1))
    rows = np.array([1, 3, 4, B], np.int32)
    kw = dict(warp=warp != "plain", q_logprobs=q,
              return_accept_prob=general_q)
    jkw = dict(kw, q_logprobs=None if q is None else jnp.asarray(q),
               warp_rows=jnp.asarray(rows) if warp == "rows" else None)
    pkw = dict(kw, q_logprobs=None if q is None else torch.tensor(q),
               warp_rows=torch.from_numpy(rows) if warp == "rows" else None)
    want = jax_sampling.spec_rejection_sample(
        jax.random.key(0), jnp.asarray(logits), jnp.asarray(draft), jsp,
        **jkw)
    gen = torch.Generator()
    gen.manual_seed(0)
    got = pt_sampling.spec_rejection_sample(
        gen, torch.from_numpy(logits), torch.from_numpy(draft), psp, **pkw)
    assert len(got) == len(want) == (5 if general_q else 4)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5)
    assert got[0].tolist() == [b % C for b in range(B)]
    if general_q:
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]))


def test_accepted_prefix_then_residual_layout():
    """Positions < accept_len are draft tokens, position accept_len the
    residual; greedy accepts iff the draft is the argmax (the reference's
    case)."""
    V = 8
    logits = np.full((1, 3, V), -10.0, np.float32)
    logits[0, 0, 2] = logits[0, 1, 5] = logits[0, 2, 1] = 10.0
    _, sp = _sp_pair([0.0])
    gen = torch.Generator()
    for draft, a_want, toks in (([2, 5], 2, [2, 5, 1]), ([4, 5], 0, [2])):
        a, tokens, lps, barg = pt_sampling.spec_rejection_sample(
            gen, torch.from_numpy(logits), torch.tensor([draft]), sp,
            warp=False)
        assert int(a[0]) == a_want
        assert tokens[0, : len(toks)].tolist() == toks
        assert int(barg[0]) == toks[-1]
        assert torch.isfinite(lps).all()


@pytest.mark.parametrize("general_q", [False, True])
def test_first_token_marginal_chi_square(general_q):
    """The first emitted token (accepted draft or residual) is distributed
    as the target, for a one-hot proposal and for a general one the drafts
    are drawn from: 20000 rows in one call, chi-square against softmax
    (df 15; the reference's limit 45)."""
    V, K, n = 16, 2, 20000
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(
        rng.normal(size=(1, K + 1, V)).astype(np.float32)).expand(n, -1, -1)
    gen = torch.Generator()
    gen.manual_seed(1)
    q_lp = None
    draft = torch.tensor([[3, 7]]).expand(n, -1)
    if general_q:
        q = torch.from_numpy(rng.normal(size=(1, K, V)).astype(np.float32))
        q_lp = torch.log_softmax(q, dim=-1).expand(n, -1, -1)
        draft = torch.stack([pt_sampling._categorical(gen, q_lp[:, i])
                             for i in range(K)], dim=1)
    _, sp = _sp_pair(np.ones(n, np.float32))
    _, tokens, _, _ = pt_sampling.spec_rejection_sample(
        gen, logits, draft, sp, warp=False, q_logprobs=q_lp)
    emp = np.bincount(tokens[:, 0].numpy(), minlength=V) / n
    want = torch.softmax(logits[0, 0], -1).numpy()
    chi2 = (n * (emp - want) ** 2 / np.maximum(want, 1e-9)).sum()
    assert chi2 < 45.0, (chi2, emp, want)


def test_warp_logits_multi_equals_jax():
    """``warp_logits_multi`` and the 3-D branch of ``warp_logits_rows``
    against the JAX functions (one sort over ``[B*C, V]``)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(4, 3, 40)).astype(np.float32)
    jsp, psp = _sp_pair([0.7, 1.0, 0.0, 1.3], [0.8, 1.0, 1.0, 0.5],
                        [5, 1 << 30, 3, 10])
    want = jax_sampling.warp_logits_multi(jnp.asarray(logits), jsp)
    got = pt_sampling.warp_logits_multi(torch.from_numpy(logits), psp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    rows = np.array([3, 0, 4], np.int32)
    want = jax_sampling.warp_logits_rows(jnp.asarray(logits), jsp,
                                         jnp.asarray(rows))
    got = pt_sampling.warp_logits_rows(torch.from_numpy(logits), psp,
                                       torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_fused_spec_rejection_greedy_equals_jax(tree):
    """``fused_spec_rejection`` (the plain streamed epilogue on the CPU)
    on greedy rows: exactly the JAX function's accept lengths, tokens and
    boundary argmax, logprobs within 1e-5."""
    rng = np.random.default_rng(9)
    B, K, E, V = 6, 3, 32, 128
    hidden = rng.normal(size=(B, K + 1, E)).astype(np.float32)
    w = tree["head"]["weight"] if "head" in tree else tree["embed"][
        "weight"].T
    w = np.array(w, np.float32)
    arg = (hidden @ w).argmax(-1)
    draft = rng.integers(0, V, size=(B, K))
    for b in range(B):
        draft[b, : b % (K + 1)] = arg[b, : b % (K + 1)]
        if b % (K + 1) < K:
            draft[b, b % (K + 1)] = (arg[b, b % (K + 1)] + 1) % V
    jsp, psp = _sp_pair(np.zeros(B, np.float32))
    want = jax_fused.fused_spec_rejection(
        jax.random.key(3), jnp.asarray(hidden), jnp.asarray(w),
        jnp.asarray(draft, jnp.int32), jsp, use_pallas=False, block_size=48)
    gen = torch.Generator()
    gen.manual_seed(3)
    got = pt_fused.fused_spec_rejection(
        gen, torch.from_numpy(hidden), torch.from_numpy(w),
        torch.from_numpy(draft), psp, block_size=48)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5)
    assert got[0].tolist() == [b % (K + 1) for b in range(B)]


def test_fused_spec_rejection_first_token_marginal_chi_square():
    """``fused_spec_rejection`` on sampled rows (temperature 1; the plain
    version on the CPU, streamed over vocab blocks): the first emitted
    token, accepted draft or residual, is distributed as the target. This
    holds only if the gathered draft logprob (the acceptance threshold),
    the excluded draft (the residual) and the boundary pick are right:
    20000 rows in one call, a one-hot draft, chi-square against softmax
    (df 15; the reference's limit 45)."""
    V, K, E, n = 16, 2, 8, 20000
    rng = np.random.default_rng(0)
    hidden = torch.from_numpy(
        rng.normal(size=(1, K + 1, E)).astype(np.float32)).expand(n, -1, -1)
    w = torch.from_numpy(rng.normal(size=(E, V)).astype(np.float32))
    logits0 = hidden[0, 0] @ w
    # draft the target's second choice, then an unlikely token
    order = torch.argsort(logits0, descending=True)
    draft = torch.tensor([[int(order[1]), int(order[-1])]]).expand(n, -1)
    _, sp = _sp_pair(np.ones(n, np.float32))
    gen = torch.Generator()
    gen.manual_seed(1)
    a, tokens, _, _ = pt_fused.fused_spec_rejection(
        gen, hidden.contiguous(), w, draft, sp, block_size=8)
    assert 0 < float((a > 0).float().mean()) < 1
    emp = np.bincount(tokens[:, 0].numpy(), minlength=V) / n
    want = torch.softmax(logits0, -1).numpy()
    chi2 = (n * (emp - want) ** 2 / np.maximum(want, 1e-9)).sum()
    assert chi2 < 45.0, (chi2, emp, want)


# --------------------------------------------------------------------------- #
# spec engines against the JAX engines
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def jax_spec_runs():
    """The JAX spec engines' outputs and spec keys on GREEDY, by (drafter,
    K, fused), unpipelined (pipelining leaves tokens as they are)."""
    cache = {}

    def get(tree, kind, k, fused=False):
        key = (kind, k, fused)
        if key not in cache:
            eng = _jax_engine(tree, kind, spec_decode=True, spec_k=k,
                              fused_sample=fused)
            cache[key] = (_run(eng, jax_engine, GREEDY, 3),
                          sorted(eng._jit_spec))
        return cache[key]

    return get


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["ngram", "draft"])
def test_spec_engine_greedy_token_exact_vs_jax(tree, jax_spec_runs, kind, k,
                                               pipelined):
    want, want_keys = jax_spec_runs(tree, kind, k)
    eng = _pt_engine(tree, kind, spec_decode=True, spec_k=k,
                     pipeline_chunks=pipelined)
    fields = ("lens", "last_tokens", "active", "n_gen", "out_tokens",
              "out_logprobs", "ctx_tokens", "fallback_token")
    ptrs = {f: getattr(eng.state, f).data_ptr() for f in fields}
    got = _run(eng, pt_engine, GREEDY, 3)
    _assert_same(got, want)
    # spec chunks update the state in place, as a replayed graph must
    assert {f: getattr(eng.state, f).data_ptr() for f in fields} == ptrs
    assert sorted(eng._jit_spec) == want_keys and not eng._jit_chunk
    st = eng.stats
    assert st["spec_draft_tokens"] > 0 and st["decode_steps"] == 0
    assert 0 < st["spec_accepted_tokens"] <= st["spec_draft_tokens"]
    assert sum(eng.spec_accept_hist.values()) * k == st["spec_draft_tokens"]
    assert (st["spec_q_accept_prob_n"] > 0) == (kind == "draft")
    assert not eng.has_inflight
    eng.prefix.clear()
    assert eng.pool.n_free == eng.n_pages


def test_fused_spec_engine_greedy_token_exact_vs_jax(tree, jax_spec_runs):
    """The fused sampler's spec path (``fused_spec_rejection``; the plain
    streamed epilogue on the CPU) emits the JAX fused spec engine's
    tokens."""
    want, want_keys = jax_spec_runs(tree, "ngram", 4, fused=True)
    eng = _pt_engine(tree, spec_decode=True, spec_k=4, fused_sample=True)
    _assert_same(_run(eng, pt_engine, GREEDY, 3), want)
    assert sorted(eng._jit_spec) == want_keys
    assert all(key[4] for key in want_keys)
    assert eng.stats["spec_fused_steps"] == eng.stats["spec_steps"] > 0


@pytest.mark.parametrize("kind", ["ngram", "draft"])
def test_spec_stop_tokens_and_min_new_tokens_vs_jax(tree, kind):
    """A stop token accepted inside a draft chain truncates the emission
    where the JAX engines stop (stop included), and ``min_new_tokens``
    holds an early stop back: port spec == JAX spec == JAX vanilla."""
    motif = _motif_prompt(3, 17)
    base = _run(_jax_engine(tree), jax_engine, [dict(
        rid="ref", input_ids=motif, max_new_tokens=14, greedy=True)], 4)
    ref = base["ref"].output_ids
    reqs = [
        dict(rid="stop", input_ids=motif, max_new_tokens=14, greedy=True,
             stop_token_ids=[ref[5]]),
        dict(rid="min", input_ids=motif, max_new_tokens=14, greedy=True,
             stop_token_ids=[ref[1]], min_new_tokens=4),
    ]
    vanilla = _run(_jax_engine(tree), jax_engine, reqs, 4)
    want = _run(_jax_engine(tree, kind, spec_decode=True, spec_k=4),
                jax_engine, reqs, 2)
    got = _run(_pt_engine(tree, kind, spec_decode=True, spec_k=4),
               pt_engine, reqs, 2)
    _assert_same(got, want)
    for rid in ("stop", "min"):
        assert got[rid].output_ids == vanilla[rid].output_ids
    assert got["stop"].finish_reason == "stop"
    assert len(got["stop"].output_ids) <= ref.index(ref[5]) + 1
    assert len(got["min"].output_ids) >= 4


def _mixed_traffic(eng, module, seed):
    """Spec toggled on and off between bursts of varied prompt lengths (the
    reference's bounded-compile traffic); returns every output."""
    rng = np.random.default_rng(seed)
    outs = {}

    def burst(tag, plens):
        for i, n in enumerate(plens):
            eng.submit(module.GenRequest(
                rid=f"{tag}{i}", input_ids=rng.integers(1, 128, n).tolist(),
                max_new_tokens=6, greedy=True))
        outs.update({o.rid: o for o in eng.run_until_done(decode_steps=3)})

    eng.spec = False
    burst("v", [3, 9, 17, 33])
    eng.spec = True
    burst("s", [3, 9, 17, 33])
    eng.spec = False
    burst("v2", [5, 21])
    eng.spec = True
    warmed = eng.n_compiles()
    eng.spec = False
    burst("v3", [11, 29, 60])
    eng.spec = True
    burst("s2", [7, 45, 80])
    assert eng.n_compiles() == warmed
    return outs


@pytest.mark.parametrize("kind", ["ngram", "draft"])
def test_spec_keys_after_mixed_traffic_equal_jax(tree, kind):
    """One engine, spec toggled between chunks: the same tokens as the JAX
    engine, spec programs keyed exactly as its ``_jit_spec`` and decode
    chunks as its ``_jit_chunk``, and no program added once warm (a draft
    engine's vanilla chunks keep its draft pool current)."""
    kw = dict(max_seqlen=256, page_size=16, spec_k=3)
    jeng = _jax_engine(tree, kind, spec_decode=False, **kw)
    peng = _pt_engine(tree, kind, spec_decode=False, **kw)
    want = _mixed_traffic(jeng, jax_engine, 5)
    got = _mixed_traffic(peng, pt_engine, 5)
    _assert_same(got, want)
    assert sorted(peng._jit_spec) == sorted(jeng._jit_spec)
    assert sorted(peng._jit_chunk) == sorted(jeng._jit_chunk)
    assert peng.n_compiles() == jeng.n_compiles()


# --------------------------------------------------------------------------- #
# composition
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["ngram", "draft"])
def test_pause_mid_spec_chunk_gives_a_valid_partial(tree, kind):
    """pause() mid generation yields an interrupted partial that is a
    prefix of the greedy chain, every page back in the pool (target and
    draft pages in lockstep), and the resubmission completes the chain."""
    prompt = _prompts(8, (5,))[0]
    ref = _run(_jax_engine(tree), jax_engine, [dict(
        rid="ref", input_ids=prompt, max_new_tokens=12, greedy=True)],
        4)["ref"].output_ids
    eng = _pt_engine(tree, kind, spec_decode=True, spec_k=3,
                     enable_prefix_cache=False)
    free0 = eng.pool.n_free
    eng.submit(pt_engine.GenRequest(rid="a", input_ids=prompt,
                                    max_new_tokens=12, greedy=True))
    eng.step(decode_steps=1)
    assert eng.pool.n_free < free0
    parts = eng.pause()
    assert eng.pool.n_free == free0
    assert len(parts) == 1 and parts[0].finish_reason == "interrupted"
    got = parts[0].output_ids
    assert 0 < len(got) < 12 and got == ref[: len(got)]
    eng.resume()
    outs = _run(eng, pt_engine, [dict(
        rid="a2", input_ids=prompt + got, max_new_tokens=12 - len(got),
        greedy=True)], 4)
    assert got + outs["a2"].output_ids == ref
    assert (eng.draft_kv_pool_bytes() > 0) == (kind == "draft")


def test_update_params_between_spec_chunks_bumps_version(tree, monkeypatch):
    """Through the env knobs (``AREAL_SPEC_DECODE=1``, ``AREAL_SPEC_K=2``):
    a weight swap between spec chunks bumps the version, clears the prefix
    cache and is read by the next chunk (the new weights' greedy tokens)."""
    monkeypatch.setenv(constants.SPEC_DECODE_ENV, "1")
    monkeypatch.setenv(constants.SPEC_K_ENV, "2")
    eng = _pt_engine(tree, max_slots=1)
    assert eng.spec is True and eng.spec_k == 2
    req = [dict(rid="a", input_ids=[1, 2, 3], max_new_tokens=5, greedy=True)]
    assert _run(eng, pt_engine, req, 2)["a"].version == 0
    new = jax.tree.map(np.asarray, jax_tfm.init_params(
        JaxConfig(**CFG_KW), jax.random.key(9)))
    eng.update_params(pt_tfm.params_from_numpy(new, device="cpu"), version=3)
    assert len(eng.prefix) == 0
    got = _run(eng, pt_engine, req, 2)["a"]
    want = _run(_jax_engine(new), jax_engine, req, 2)["a"]
    assert got.version == 3 and got.output_ids == want.output_ids


def test_draft_weight_swap_bumps_draft_version(tree):
    """``update_draft_params`` copies into the engine's draft tensors (a
    replayed graph reads them), bumps ``draft_version`` but not the policy
    version, clears the prefix cache and leaves greedy outputs as they
    were; ``update_params(draft_params=)`` moves both versions."""
    eng = _pt_engine(tree, "draft", max_slots=1, spec_decode=True, spec_k=2)
    ptrs = [t.data_ptr() for t in eng.draft_params["layers"][0]["attn"]
            .values()]
    req = [dict(rid="a", input_ids=[1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
                max_new_tokens=6, greedy=True)]
    o0 = _run(eng, pt_engine, req, 2)["a"]
    assert len(eng.prefix) > 0
    dcfg = JaxConfig(**{**CFG_KW, "n_layers": 1})
    new_draft = pt_tfm.params_from_numpy(jax.tree.map(
        np.asarray, jax_tfm.init_params(dcfg, jax.random.key(9))),
        device="cpu")
    eng.update_draft_params(new_draft)
    assert eng.draft_version == 1 and eng.version == 0
    assert len(eng.prefix) == 0
    assert [t.data_ptr() for t in eng.draft_params["layers"][0]["attn"]
            .values()] == ptrs
    assert torch.equal(eng.draft_params["layers"][0]["attn"]["wq"],
                       new_draft["layers"][0]["attn"]["wq"])
    o1 = _run(eng, pt_engine, req, 2)["a"]
    assert o1.output_ids == o0.output_ids and o1.version == 0
    eng.update_params(pt_tfm.params_from_numpy(tree, device="cpu"),
                      version=3, draft_params=new_draft)
    assert eng.version == 3 and eng.draft_version == 2
    bad = dict(new_draft, embed={"weight": new_draft["embed"]["weight"][:64]})
    with pytest.raises(ValueError, match="shape"):
        eng.update_draft_params(bad)
    assert eng.draft_version == 2


def test_adaptive_k_moves_one_step_like_jax(tree):
    """The same accept-length windows through both engines' stats fold:
    K moves one step over ``{1, 2, 4, 8} | {spec_k}`` (up past 0.75 K,
    down under 0.25 K, held in between), as the reference's does."""
    peng = _pt_engine(tree, spec_decode=True, spec_k=3, spec_k_adapt=True)
    jeng = _jax_engine(tree, spec_decode=True, spec_k=3, spec_k_adapt=True)
    assert peng._spec_k_choices == jeng._spec_k_choices == [1, 2, 3, 4, 8]
    B = 4
    ks = []
    for acc in (3, 3, 4, 4, 2, 0, 0, 0):
        k = peng.spec_k
        drafted = np.full((32, B), k)
        accepted = np.full((32, B), min(acc, k))
        peng._fold_spec_stats(np.stack([drafted, accepted,
                                        np.zeros_like(drafted)]).astype(
                                            np.float32))
        jeng._fold_spec_stats((drafted, accepted))
        assert peng.spec_k == jeng.spec_k
        ks.append(peng.spec_k)
    assert ks == [4, 8, 8, 8, 4, 3, 2, 1]


def test_sampled_spec_engine_is_seeded_and_varies(tree):
    """Sampled spec decode (top-p through the warp rows, plain
    temperature) reproduces per seed and differs across slots."""
    outs = []
    for _ in range(2):
        eng = _pt_engine(tree, spec_decode=True, spec_k=3, seed=7)
        reqs = [dict(rid=f"s{i}", input_ids=[5, 6, 7], max_new_tokens=8,
                     temperature=1.0, top_p=0.95 if i % 2 else 1.0)
                for i in range(4)]
        outs.append({r: o.output_ids
                     for r, o in _run(eng, pt_engine, reqs, 2).items()})
    assert outs[0] == outs[1]
    assert len({tuple(v) for v in outs[0].values()}) > 1


def test_draft_engine_first_token_marginal_chi_square():
    """The port's whole draft-model path (sampled proposals from q, the
    verify, general-q rejection) leaves the first emitted token
    distributed as the target: chi-square on a 32-token vocabulary against
    a packed forward's softmax (df 31; the reference's limit 75)."""
    cfg = PtConfig(n_layers=2, n_q_heads=2, n_kv_heads=2, head_dim=8,
                   hidden_dim=16, intermediate_dim=32, vocab_size=32,
                   dtype="float32")
    params = pt_tfm.init_params(cfg, seed=3, device="cpu")
    dcfg = dataclasses.replace(cfg, n_layers=1)
    drafter = pt_drafter.TransformerDrafter(
        dcfg, pt_tfm.init_params(dcfg, seed=77, device="cpu"))
    eng = pt_engine.GenerationEngine(
        cfg, params, max_slots=16, max_seqlen=32, page_size=8,
        spec_decode=True, spec_k=2, drafter=drafter,
        enable_prefix_cache=False, device="cpu")
    prompt = [3, 9, 4, 1]
    counts = np.zeros(32)
    r = 0
    while counts.sum() < 2048:
        for i in range(16):
            eng.submit(pt_engine.GenRequest(rid=f"{r}_{i}",
                                            input_ids=prompt,
                                            max_new_tokens=1,
                                            temperature=1.0))
        for o in eng.run_until_done(decode_steps=1):
            counts[o.output_ids[0]] += 1
        r += 1
    t = torch.tensor(prompt)
    with torch.no_grad():
        logits = pt_tfm.forward_packed(
            params, cfg, t, torch.ones_like(t, dtype=torch.int32),
            torch.arange(len(prompt), dtype=torch.int32), remat=False)[-1]
    want = torch.softmax(logits.float(), -1).numpy()
    emp = counts / counts.sum()
    chi2 = (counts.sum() * (emp - want) ** 2 / np.maximum(want, 1e-9)).sum()
    assert chi2 < 75.0, (chi2, emp, want)
    assert eng.stats["spec_q_accept_prob_n"] > 0


# --------------------------------------------------------------------------- #
# the drafter checks
# --------------------------------------------------------------------------- #


def test_drafter_checks_at_construction(tree):
    """A sampled drafter without q raises, so does one that declares q
    outside the model interface and a vocab mismatch; a draft in another
    dtype is coerced to the target's, in the drafter's cfg too."""
    cfg = PtConfig(**CFG_KW)
    params = pt_tfm.params_from_numpy(tree, device="cpu")
    kw = dict(max_slots=2, max_seqlen=64, spec_decode=True, device="cpu")

    class Sampled(pt_drafter.Drafter):
        deterministic = False

    class Lying(pt_drafter.Drafter):
        deterministic = False
        provides_q_logprobs = True

    with pytest.raises(NotImplementedError, match="q_logprobs"):
        pt_engine.GenerationEngine(cfg, params, drafter=Sampled(), **kw)
    with pytest.raises(NotImplementedError, match="TransformerDrafter"):
        pt_engine.GenerationEngine(cfg, params, drafter=Lying(), **kw)
    bad = dataclasses.replace(cfg, vocab_size=64, n_layers=1)
    with pytest.raises(ValueError, match="vocab"):
        pt_engine.GenerationEngine(cfg, params, drafter=pt_drafter
                                   .TransformerDrafter(bad, pt_tfm.init_params(
                                       bad, seed=0, device="cpu")), **kw)
    dcfg = dataclasses.replace(cfg, n_layers=1, dtype="bfloat16")
    drafter = pt_drafter.TransformerDrafter(
        dcfg, pt_tfm.init_params(dcfg, seed=7, device="cpu",
                                 dtype=torch.bfloat16))
    eng = pt_engine.GenerationEngine(cfg, params, drafter=drafter, **kw)
    assert eng.draft_cfg.dtype == eng.drafter.cfg.dtype == "float32"
    assert eng.draft_params["layers"][0]["attn"]["wq"].dtype == torch.float32
    with pytest.raises(ValueError, match="n_layers"):
        pt_drafter.TransformerDrafter.shared_prefix(cfg, params, 3)


def test_env_draft_model_ignored_when_spec_disabled(tree, monkeypatch):
    """``AREAL_SPEC_DRAFT_MODEL`` must not make a spec-disabled engine pay
    for a draft model: the (bogus) path is never touched."""
    monkeypatch.setenv(constants.SPEC_DRAFT_MODEL_ENV, "/nonexistent/draft")
    eng = _pt_engine(tree, spec_decode=False)
    assert eng._draft is None and isinstance(eng.drafter,
                                             pt_drafter.NGramDrafter)
    assert eng.state.draft_cache is None and eng.draft_kv_pool_bytes() == 0


def test_env_draft_model_and_int8_draft_pool(tree, tmp_path, monkeypatch):
    """With spec on, ``AREAL_SPEC_DRAFT_MODEL`` loads the HF dir as the
    drafter and ``AREAL_SPEC_DRAFT_KV_DTYPE=int8`` quantizes its pool (a
    quarter of the f32 pool's bytes plus the scales); greedy tokens stay
    the vanilla engine's."""
    from areal_tpu_torch.models import hf as hf_conv

    dcfg = PtConfig(**{**CFG_KW, "n_layers": 1})
    params = pt_tfm.params_from_numpy(tree, device="cpu")
    shared = pt_drafter.TransformerDrafter.shared_prefix(
        PtConfig(**CFG_KW), params, 1)
    hf_conv.save_hf_checkpoint(pt_tfm.params_to_numpy(shared.params), dcfg,
                               "llama", str(tmp_path))
    monkeypatch.setenv(constants.SPEC_DRAFT_MODEL_ENV, str(tmp_path))
    monkeypatch.setenv(constants.SPEC_DRAFT_KV_DTYPE_ENV, "int8")
    eng = _pt_engine(tree, spec_decode=True, spec_k=3)
    assert isinstance(eng.drafter, pt_drafter.TransformerDrafter)
    assert eng.draft_kv_dtype == "int8" and eng.state.draft_cache.quantized
    f32_bytes = eng._pool_bytes_for(dcfg, False)
    assert eng.draft_kv_pool_bytes() == f32_bytes // 4 + f32_bytes // 8
    reqs = GREEDY[:2]
    _assert_same(_run(eng, pt_engine, reqs, 3),
                 _run(_jax_engine(tree), jax_engine, reqs, 3))


def test_fused_spec_engine_with_warping_slots(tree):
    """Under the fused sampler, top-p and top-k slots take the sorted
    rejection sampler over their own verify rows (the warp-row bucket)
    while greedy slots beside them keep the JAX engine's greedy tokens."""
    reqs = [dict(rid="g0", input_ids=GREEDY[0]["input_ids"],
                 max_new_tokens=12, greedy=True),
            dict(rid="g1", input_ids=GREEDY[3]["input_ids"],
                 max_new_tokens=12, greedy=True),
            dict(rid="p", input_ids=[5, 6, 7], max_new_tokens=12,
                 temperature=1.0, top_p=0.9),
            dict(rid="k", input_ids=[8, 9], max_new_tokens=12,
                 temperature=1.0, top_k=5)]
    want = _run(_jax_engine(tree), jax_engine, reqs[:2], 3)
    eng = _pt_engine(tree, spec_decode=True, spec_k=4, fused_sample=True)
    got = _run(eng, pt_engine, reqs, 3)
    for rid in ("g0", "g1"):
        assert got[rid].output_ids == want[rid].output_ids, rid
    assert all(len(got[r].output_ids) == 12 for r in ("p", "k"))
    assert all(np.isfinite(got[r].output_logprobs).all() for r in got)
    assert {key[2] for key in eng._jit_spec} >= {2}
    assert eng.stats["sampler_fallback_rows"] > 0
