"""Port parity: mixture-of-experts (``areal_tpu_torch/ops/moe.py`` and
the MoE paths of the model, trainer, interfaces and generators) against
``areal_tpu`` on the CPU.

One tiny Mixtral-like float32 config (2 layers, hidden 32, 4 experts, top
2, aux 0.02, z 0.001) and numpy inputs from a seed feed both packages
(``params_from_numpy`` carries the JAX param tree across). Float32 on both
sides, so the differences are summation order only. Tolerances:

- ``moe_mlp`` (both dispatches, top-k 1, 2, 3): output, aux and every
  parameter gradient to 2e-5, as ``tests/test_moe.py`` holds ragged to
  dense; the reference's ragged gradient is taken under a one-row vmap
  (its un-vmapped reverse mode is unsupported);
- ``forward_packed(with_aux=True)`` under each remat policy, the
  ``vmapped_forward`` estimators over 2 rows, the generation paths
  (``prefill`` / ``decode_step``, ``extend_paged`` / ``decode_step_paged``
  / ``verify_step_paged``): 1e-4 (logits over two layers); gradients to
  1e-5 of the leaf's largest, and equal to ``full``'s to the bit under
  every policy;
- the engines' greedy tokens (paged engine, ``SyncGenerator``, a
  shared-prefix draft model): equal to the JAX engines' token for token;
- SFT, PPO actor and critic steps with nonzero aux: loss and grad norm to
  rtol 1e-5 (1e-4 for PPO stats), weights to 1% of lr per step.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from areal_tpu.api import data as jax_data
from areal_tpu.api import model as jax_model
from areal_tpu.gen import engine as jax_gen
from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu.models.config import MoEConfig as JaxMoE
from areal_tpu.ops import moe as jax_moe
from areal_tpu.train import engine as jax_engine
from areal_tpu.train.generation import SyncGenerator as JaxSyncGenerator
from areal_tpu_torch.api import data as pt_data
from areal_tpu_torch.api import model as pt_model
from areal_tpu_torch.gen import engine as pt_gen
from areal_tpu_torch.gen.drafter import TransformerDrafter
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig
from areal_tpu_torch.models.config import MoEConfig as PtMoE
from areal_tpu_torch.ops import moe as pt_moe
from areal_tpu_torch.train import engine as pt_engine
from areal_tpu_torch.train.generation import SyncGenerator

MODEL = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
             hidden_dim=32, intermediate_dim=48, vocab_size=128,
             n_positions=128, dtype="float32", mlp_type="moe")
MOE = dict(num_experts=4, top_k=2, aux_loss_coeff=0.02, z_loss_coeff=0.001)
TOL = dict(atol=1e-4, rtol=1e-4)
MLP_TOL = dict(atol=2e-5, rtol=2e-5)
LR = 1e-3
W_ATOL = 0.01 * LR * 2       # 1% of lr per step, two steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dispatch="dense", **kw):
    """The same config in both packages: (JAX, port)."""
    moe = dict(MOE, dispatch=dispatch, **kw.pop("moe", {}))
    model = dict(MODEL, **kw)
    return (JaxConfig(**model, moe=JaxMoE(**moe)),
            PtConfig(**model, moe=PtMoE(**moe)))


def _tree(seed=0):
    """The JAX init, then numpy noise on every leaf (norm gains off their
    trivial 1): continuous values, so no routing tie."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray,
                        jax_tfm.init_params(_cfgs()[0], jax.random.key(seed)))
    return jax.tree.map(
        lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def tree():
    return _tree()


def _port(tree, grad=False):
    params = pt_tfm.params_from_numpy(tree, device="cpu")
    if grad:
        params = pt_tfm.tree_map(lambda t: t.requires_grad_(True), params)
    return params


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------- #
# ops/moe.py
# --------------------------------------------------------------------------- #


def _mlp_params(seed=0, E=16, F=32, X=4):
    rng = np.random.default_rng(seed)
    shapes = dict(router=(E, X), w_gate=(X, E, F), w_up=(X, E, F),
                  w_down=(X, F, E))
    return {k: (rng.normal(size=s) * 0.1).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_moe_mlp_matches_the_reference(dispatch, top_k):
    jcfg, pcfg = _cfgs(dispatch, hidden_dim=16, intermediate_dim=32,
                       moe=dict(top_k=top_k))
    p = _mlp_params()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 17, 16)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def jax_loss(params):
        out, aux = jax.vmap(lambda row: jax_moe.moe_mlp(jcfg, params, row))(
            jnp.asarray(x)[None].reshape(1, -1, 16))
        return jnp.sum(out.reshape(x.shape) * w) + jnp.mean(aux), (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, p))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    out, aux = pt_moe.moe_mlp(pcfg, tp, _t(x))
    ((out * _t(w)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jout).reshape(x.shape), **MLP_TOL)
    aux = aux.detach()
    np.testing.assert_allclose(float(aux), float(jaux[0]), **MLP_TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgrads[k]),
                                   **MLP_TOL, err_msg=k)


def test_dense_aux_and_routing_helpers_match_the_reference():
    jcfg, pcfg = _cfgs(hidden_dim=16, intermediate_dim=32)
    p = _mlp_params(2)
    x = np.random.default_rng(3).normal(size=(29, 16)).astype(np.float32)
    jc, jl = jax_moe.router_probs(jcfg, jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x))
    pc, pl = pt_moe.router_probs(pcfg, {k: _t(v) for k, v in p.items()},
                                 _t(x))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **MLP_TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **MLP_TOL)
    np.testing.assert_allclose(
        float(pt_moe.load_balancing_aux_loss(pcfg, pc, pl)),
        float(jax_moe.load_balancing_aux_loss(jcfg, jc, jl)), **MLP_TOL)
    assert int((pc > 0).sum()) == 29 * pcfg.moe.top_k


def test_unknown_dispatch_raises():
    _, pcfg = _cfgs("sparse", hidden_dim=16, intermediate_dim=32)
    p = {k: _t(v) for k, v in _mlp_params().items()}
    with pytest.raises(ValueError, match="'dense' or 'ragged'.*'sparse'"):
        pt_moe.moe_mlp(pcfg, p, torch.zeros(4, 16))


# --------------------------------------------------------------------------- #
# the model: forward_packed with aux, params
# --------------------------------------------------------------------------- #


def _packed(seed=3, n=5):
    """One packed row of ``n`` sequences of 5-20 random tokens and 7
    padding tokens."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(5, 21, size=n)
    ids = rng.integers(0, 128, size=int(lens.sum()) + 7).astype(np.int32)
    seg = np.concatenate([np.full(n_, i + 1, np.int32)
                          for i, n_ in enumerate(lens)] + [np.zeros(7, np.int32)])
    pos = np.concatenate([np.arange(n_, dtype=np.int32) for n_ in lens]
                         + [np.zeros(7, np.int32)])
    return ids, seg, pos


def test_params_round_trip_the_expert_leaves(tree):
    """``[L, X, E, F]`` leaves survive ``params_from_numpy`` /
    ``params_to_numpy``; ``init_params`` lays them out alike."""
    params = _port(tree)
    assert params["layers"][1]["mlp"]["w_gate"].shape == (4, 32, 48)
    assert params["layers"][0]["mlp"]["w_down"].shape == (4, 48, 32)
    back = pt_tfm.params_to_numpy(params)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, leaf)
    assert back["layers"]["mlp"]["w_up"].shape == (2, 4, 32, 48)
    fresh = pt_tfm.init_params(_cfgs()[1], seed=1, device="cpu")
    assert pt_tfm.tree_map(lambda t: tuple(t.shape), fresh) == pt_tfm.tree_map(
        lambda t: tuple(t.shape), params)


def _policy_batch():
    ids, seg, pos = _packed()
    w = np.random.default_rng(4).normal(size=(len(ids), 128)).astype(
        np.float32) * (seg > 0)[:, None]
    return ids, seg, pos, w


@pytest.fixture(scope="module")
def jax_full_policy(tree):
    """The reference's output, aux and gradients of ``sum(out * w) + aux``
    under ``full`` remat (its policies differ in what they save, not in
    what they compute)."""
    jcfg = _cfgs(remat_policy="full")[0]
    ids, seg, pos, w = _policy_batch()

    def jax_loss(p):
        out, aux = jax_tfm.forward_packed(p, jcfg, ids, seg, pos,
                                          with_aux=True)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (out, aux)), grads = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree))
    return np.asarray(out), float(aux), jax.device_get(grads)


def _port_policy(tree, policy):
    ids, seg, pos, w = _policy_batch()
    params = _port(tree, grad=True)
    pcfg = _cfgs(remat_policy=policy)[1]
    out, stats = pt_tfm.forward_packed(params, pcfg, _t(ids).long(),
                                       _t(seg), _t(pos), with_aux=True)
    assert stats.shape == (pcfg.n_layers, 2 * pcfg.moe.num_experts + 2)
    aux = pt_moe.aux_loss(pcfg, stats)
    ((out * _t(w)).sum() + aux).backward()
    return out.detach(), aux.detach(), pt_tfm.params_to_numpy(
        pt_tfm.tree_map(lambda t: t.grad, params))


@pytest.mark.parametrize("policy", ["full", "dots", "dots_attn", "none"])
def test_forward_packed_with_aux_under_every_policy(tree, jax_full_policy,
                                                    policy):
    """Output, aux and every gradient of ``sum(out * w) + aux`` against the
    reference; the port's gradients under each policy equal to its
    ``full`` policy's to the bit (the aux is an output of each
    checkpointed region)."""
    jout, jaux, jgrads = jax_full_policy
    out, aux, grads = _port_policy(tree, policy)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-5)
    assert float(aux) > 0
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        got = grads
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got, g, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=jax.tree_util.keystr(path))
    if policy != "full":
        _, _, full = _port_policy(tree, "full")
        for a, b in zip(jax.tree_util.tree_leaves(grads),
                        jax.tree_util.tree_leaves(full)):
            np.testing.assert_array_equal(a, b)


def _rows_arrays(n_rows=2):
    rows = [_packed(seed=5 + r, n=3) for r in range(n_rows)]
    T = max(len(r[0]) for r in rows)
    pad = lambda a: np.pad(a, (0, T - len(a)))  # noqa: E731
    return {k: np.stack([pad(r[i]) for r in rows])
            for i, k in enumerate(("input_ids", "segment_ids", "positions"))}


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_vmapped_aux_estimators_match_the_reference(tree, dispatch, chunk):
    """Two packed rows: ``dense`` means the rows' auxes, ``ragged`` takes
    one aux over both rows' tokens, as the reference's vmap folds them."""
    jcfg, pcfg = _cfgs(dispatch, loss_chunk_size=chunk)
    arrays = _rows_arrays()
    jlp, jaux = jax_engine.vmapped_next_token_logprobs(
        jax.tree.map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in arrays.items()}, with_aux=True)
    params = _port(tree)
    targs = {k: _t(v) for k, v in arrays.items()}
    targs["input_ids"] = targs["input_ids"].long()
    lp, aux = pt_engine.vmapped_next_token_logprobs(params, pcfg, targs,
                                                    with_aux=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # the two estimators are different objectives over two rows
    other = "dense" if dispatch == "ragged" else "ragged"
    _, aux_other = pt_engine.vmapped_forward(
        params, dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, dispatch=other)), targs, with_aux=True)
    assert abs(float(aux_other) - float(aux)) > 1e-6


def test_dense_mlp_aux_is_zero():
    cfg = PtConfig(**dict(MODEL, mlp_type="gated"))
    params = pt_tfm.init_params(cfg, seed=0, device="cpu")
    ids, seg, pos = _packed()
    out, stats = pt_tfm.forward_packed(params, cfg, _t(ids).long(),
                                       _t(seg), _t(pos), with_aux=True)
    assert stats.shape == (cfg.n_layers, 0)
    assert float(pt_moe.aux_loss(cfg, stats)) == 0.0
    assert out.shape == (len(ids), 128)


# --------------------------------------------------------------------------- #
# the generation paths on an MoE config
# --------------------------------------------------------------------------- #


def test_dense_kv_prefill_and_decode_match_the_reference(tree):
    jcfg, pcfg = _cfgs()
    jp, pp = jax.tree.map(jnp.asarray, tree), _port(tree)
    rng = np.random.default_rng(1)
    B, Sp, S = 3, 16, 32
    plens = np.array([16, 5, 1], np.int32)
    ids = np.zeros((B, Sp), np.int32)
    for b, n in enumerate(plens):
        ids[b, :n] = rng.integers(0, 128, n)
    jlog, jc = jax_tfm.prefill(jp, jcfg, jax_tfm.KVCache.empty(jcfg, B, S),
                               jnp.asarray(ids), jnp.asarray(plens))
    plog, pc = pt_tfm.prefill(pp, pcfg,
                              pt_tfm.KVCache.empty(pcfg, B, S, device="cpu"),
                              _t(ids).long(), _t(plens))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
    for step in range(3):
        tok = rng.integers(0, 128, B).astype(np.int32)
        act = np.array([True, step != 1, True])
        jlog, jc = jax_tfm.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                       jnp.asarray(act))
        plog, pc = pt_tfm.decode_step(pp, pcfg, pc, _t(tok).long(), _t(act))
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc.k), **TOL)


def test_paged_extend_verify_and_decode_match_the_reference(tree):
    jcfg, pcfg = _cfgs()
    jp, pp = jax.tree.map(jnp.asarray, tree), _port(tree)
    page, n_pages = 8, 16
    jcache = jax_tfm.PagedKVCache.empty(jcfg, n_pages, page)
    pcache = pt_tfm.PagedKVCache.empty(pcfg, n_pages, page, device="cpu")
    rng = np.random.default_rng(4)
    B, C, W = 3, 8, 4
    table = rng.permutation(n_pages)[:B * W].reshape(B, W).astype(np.int32)
    for start, n_new, skip in (
            (np.zeros(B, np.int32), np.array([8, 5, 8], np.int32), True),
            (np.array([8, 5, 8], np.int32), np.array([6, 8, 2], np.int32),
             False)):
        tokens = rng.integers(0, 128, size=(B, C)).astype(np.int32)
        jcache = jax_tfm.extend_paged(jp, jcfg, jcache, tokens, table, start,
                                      n_new, skip_pool=skip)
        pt_tfm.extend_paged(pp, pcfg, pcache, _t(tokens).long(), _t(table),
                            _t(start), _t(n_new), skip_pool=skip)
    np.testing.assert_allclose(pcache.pages.numpy(), np.asarray(jcache.pages),
                               **TOL)
    lens = np.array([14, 13, 10], np.int32)
    # verify: 3 query tokens per slot, the last slot inactive
    vt = rng.integers(0, 128, size=(B, 3)).astype(np.int32)
    active = np.array([True, True, False])
    n_new = np.where(active, 3, 0).astype(np.int32)
    write = np.repeat(active[:, None], 3, 1)
    jv, _ = jax_tfm.verify_step_paged(
        jp, jcfg, jcache, jnp.asarray(vt), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(n_new), jnp.asarray(write))
    pv, _ = pt_tfm.verify_step_paged(
        pp, pcfg, pt_tfm.PagedKVCache.from_pages(pcache.pages.clone()),
        _t(vt).long(), _t(table), _t(lens), _t(n_new), _t(write))
    np.testing.assert_allclose(pv.numpy()[active], np.asarray(jv)[active],
                               **TOL)
    cur = rng.integers(0, 128, size=(B,)).astype(np.int32)
    jlog, jcache, jlens = jax_tfm.decode_step_paged(
        jp, jcfg, jcache, cur, table, lens, active, use_pallas=False)
    plog, pcache, plens = pt_tfm.decode_step_paged(
        pp, pcfg, pcache, _t(cur).long(), _t(table), _t(lens), _t(active))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_array_equal(plens.numpy(), np.asarray(jlens))
    np.testing.assert_allclose(pcache.pages.numpy(), np.asarray(jcache.pages),
                               **TOL)


ENGINE_KW = dict(max_slots=4, max_seqlen=128, page_size=8)


def _requests():
    """An 4-way group on one 19-token prompt (shared pages) and three
    others, more requests than slots."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 128, 19).tolist()
    reqs = [dict(rid=f"g{i}", input_ids=shared, max_new_tokens=8, greedy=True)
            for i in range(4)]
    reqs += [dict(rid=f"p{i}", input_ids=rng.integers(1, 128, n).tolist(),
                  max_new_tokens=10, greedy=True) for i, n in enumerate(
                      (5, 11, 2))]
    return reqs


def _serve(eng, module, reqs):
    for r in reqs:
        eng.submit(module.GenRequest(**r))
    return {o.rid: o for o in eng.run_until_done(decode_steps=4)}


@pytest.fixture(scope="module")
def jax_greedy(tree):
    eng = jax_gen.GenerationEngine(_cfgs()[0], jax.tree.map(jnp.asarray, tree),
                                   **ENGINE_KW)
    return _serve(eng, jax_gen, _requests())


@pytest.mark.parametrize("arm", ["vanilla", "draft"])
def test_engine_greedy_matches_the_reference(tree, jax_greedy, arm):
    """The paged engine on the MoE config, token for token with the JAX
    engine; and with a 1-layer shared-prefix draft model (the drafter runs
    the target's layer code): spec decode keeps greedy tokens exact."""
    pcfg = _cfgs()[1]
    kw = {}
    if arm == "draft":
        kw = dict(spec_decode=True, spec_k=2,
                  drafter=TransformerDrafter.shared_prefix(
                      pcfg, _port(tree), 1))
    eng = pt_gen.GenerationEngine(pcfg, _port(tree), device="cpu",
                                  **ENGINE_KW, **kw)
    got = _serve(eng, pt_gen, _requests())
    assert set(got) == set(jax_greedy)
    for rid, w in jax_greedy.items():
        assert got[rid].output_ids == w.output_ids, rid
        np.testing.assert_allclose(got[rid].output_logprobs,
                                   w.output_logprobs, atol=1e-4)
    assert eng.stats["prefix_hits"] > 0
    if arm == "draft":
        assert eng.stats["spec_steps"] > 0 and eng.stats["decode_steps"] == 0


def test_engine_serves_its_own_copy_of_moe_params(tree, jax_greedy):
    """The engine copies every leaf it would otherwise share with the
    caller, the router and the 3-D expert leaves too (weight updates copy
    into its tensors), and a caller that then overwrites its own params
    does not move the engine's greedy tokens."""
    params = pt_tfm.tree_map(lambda t: t.clone(), _port(tree))
    eng = pt_gen.GenerationEngine(_cfgs()[1], params, device="cpu",
                                  **ENGINE_KW)
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert eng.params["layers"][1]["mlp"][name].data_ptr() != (
            params["layers"][1]["mlp"][name].data_ptr()), name
    pt_tfm.tree_map(lambda t: t.zero_(), params)
    got = _serve(eng, pt_gen, _requests())
    assert {r: o.output_ids for r, o in got.items()} == {
        r: o.output_ids for r, o in jax_greedy.items()}


def test_sync_generator_greedy_matches_the_reference(tree):
    jcfg, pcfg = _cfgs()
    jeng = jax_engine.TrainEngine(jcfg).load_params(tree)
    peng = pt_engine.TrainEngine(pcfg, device="cpu").load_params(tree)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11]]
    kw = dict(n=2, max_new_tokens=10, greedy=True)
    want = JaxSyncGenerator(jeng).generate(
        prompts, jax_model.GenerationHyperparameters(**kw), seed=0)
    got = SyncGenerator(peng).generate(
        prompts, pt_model.GenerationHyperparameters(**kw), seed=0)
    for g_group, w_group in zip(got, want):
        for g, w in zip(g_group, w_group):
            np.testing.assert_array_equal(g.tokens, w.tokens)
            np.testing.assert_allclose(g.gen_logprobs, w.gen_logprobs,
                                       **TOL)


def test_graphed_paths_refuse_the_ragged_dispatch(tree):
    """Every engine program and SyncGenerator's decode step is a CUDA graph
    on the card (the same body on the CPU): a ragged config raises when
    the path is built, naming the dispatch; nothing falls back to dense."""
    dense, ragged = _cfgs()[1], _cfgs("ragged")[1]
    with pytest.raises(ValueError, match='dispatch="ragged"'):
        pt_gen.GenerationEngine(ragged, _port(tree), device="cpu",
                                **ENGINE_KW)
    draft = TransformerDrafter.shared_prefix(ragged, _port(tree), 1)
    with pytest.raises(ValueError, match='draft model.*dispatch="ragged"'):
        pt_gen.GenerationEngine(dense, _port(tree), device="cpu",
                                spec_decode=True, drafter=draft, **ENGINE_KW)
    with pytest.raises(ValueError, match='SyncGenerator.*dispatch="ragged"'):
        SyncGenerator(pt_engine.TrainEngine(ragged, device="cpu")
                      .load_params(tree))


# --------------------------------------------------------------------------- #
# the trainer and the interfaces: loss + aux
# --------------------------------------------------------------------------- #


def _engines(dispatch="dense", seed=0, **kw):
    jcfg, pcfg = _cfgs(dispatch, **kw)
    host = _tree(seed)
    if kw.get("is_critic"):
        rng = np.random.default_rng(seed)
        host["head"] = {"weight": (rng.normal(size=(32, 1)) * 0.02).astype(
            np.float32)}
    jeng = jax_engine.TrainEngine(
        jcfg, optimizer=jax_engine.OptimizerConfig(lr=LR)).load_params(host)
    peng = pt_engine.TrainEngine(
        pcfg, optimizer=pt_engine.OptimizerConfig(lr=LR),
        device="cpu").load_params(host)
    return jeng.setup_optimizer(100), peng.setup_optimizer(100)


def _sample(mod, seed, n_items=4, group=2):
    rng = np.random.default_rng(seed)
    seqlens, ids, pm, lps = [], [], [], []
    for _ in range(n_items):
        inner = []
        for _ in range(group):
            plen, glen = int(rng.integers(2, 5)), int(rng.integers(3, 9))
            inner.append(plen + glen)
            ids.append(rng.integers(0, 128, size=plen + glen))
            pm.append(np.r_[np.ones(plen, bool), np.zeros(glen, bool)])
            lp = np.zeros(plen + glen, np.float32)
            lp[plen - 1:-1] = rng.normal(size=glen) * 0.1 - 1.0
            lps.append(lp)
        seqlens.append(inner)
    tok = dict(packed_input_ids=np.concatenate(ids).astype(np.int64),
               prompt_mask=np.concatenate(pm),
               packed_logprobs=np.concatenate(lps),
               packed_ref_logprobs=np.concatenate(lps) * 0.9)
    n = n_items * group
    keys = dict(tok, rewards=rng.normal(size=n).astype(np.float32),
                seq_no_eos_mask=np.zeros(n, bool))
    scalar = [[1] * group for _ in range(n_items)]
    return mod.SequenceSample(
        keys=set(keys), ids=list(range(n_items)),
        seqlens={k: (scalar if k in ("rewards", "seq_no_eos_mask")
                     else seqlens) for k in keys},
        data={k: np.array(v) for k, v in keys.items()})


def _assert_weights_match(jeng, peng, atol=W_ATOL):
    got = pt_tfm.params_to_numpy(peng.params)
    for path, w in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jeng.params)):
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dispatch", ["dense", "ragged"])
def test_sft_steps_with_aux_match_the_reference(dispatch):
    from areal_tpu.interfaces.sft import sft_loss_fn as jax_sft
    from areal_tpu_torch.interfaces.sft import sft_loss_fn as pt_sft

    jeng, peng = _engines(dispatch, seed=2)
    js, ps = _sample(jax_data, 7), _sample(pt_data, 7)
    spec = dict(max_tokens_per_mb=32)
    for step in range(2):
        jst = jeng.train_batch(js, jax_data.MicroBatchSpec(**spec), jax_sft)
        pst = peng.train_batch(ps, pt_data.MicroBatchSpec(**spec), pt_sft)
        assert pst["n_mbs"] == jst["n_mbs"] > 1
        for k in ("loss", "grad_norm", "ppl", "n_tokens"):
            np.testing.assert_allclose(pst[k], jst[k], rtol=1e-5, err_msg=k)
        # the loss carries the aux, the perplexity does not
        assert pst["loss"] > np.log(pst["ppl"]) + 1e-3
    _assert_weights_match(jeng, peng)


def test_ppo_actor_step_with_aux_matches_the_reference():
    hp = dict(ppo_n_minibatches=2, use_decoupled_loss=True, kl_ctl=0.05)
    jeng, peng = _engines(seed=5)
    jact = jax_model.make_interface(
        "ppo_actor", hp=jax_model.PPOHyperparameters(**hp))
    pact = pt_model.make_interface(
        "ppo_actor", hp=pt_model.PPOHyperparameters(**hp))
    js, ps = _sample(jax_data, 10), _sample(pt_data, 10)
    spec = dict(max_tokens_per_mb=128)
    js.update_(jact.inference(jeng, js, jax_data.MicroBatchSpec(**spec)))
    ps.update_(pact.inference(peng, ps, pt_data.MicroBatchSpec(**spec)))
    np.testing.assert_allclose(ps.data["prox_logp"], js.data["prox_logp"],
                               **TOL)
    ps.data["prox_logp"] = js.data["prox_logp"].copy()
    jst = jact.train_step(jeng, js, jax_data.MicroBatchSpec(**spec))
    pst = pact.train_step(peng, ps, pt_data.MicroBatchSpec(**spec))
    assert set(jst) == set(pst)
    for k in jst:
        np.testing.assert_allclose(pst[k], jst[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    _assert_weights_match(jeng, peng)


def test_ppo_critic_step_with_aux_matches_the_reference():
    hp = dict(ppo_n_minibatches=1)
    jeng, peng = _engines(seed=6, is_critic=True)
    jcr = jax_model.make_interface(
        "ppo_critic", hp=jax_model.PPOHyperparameters(**hp))
    pcr = pt_model.make_interface(
        "ppo_critic", hp=pt_model.PPOHyperparameters(**hp))
    js, ps = _sample(jax_data, 11), _sample(pt_data, 11)
    spec = dict(max_tokens_per_mb=64)
    js.update_(jcr.inference(jeng, js, jax_data.MicroBatchSpec(**spec)))
    ps.update_(pcr.inference(peng, ps, pt_data.MicroBatchSpec(**spec)))
    np.testing.assert_allclose(ps.data["values"], js.data["values"], **TOL)
    ps.data["values"] = js.data["values"].copy()
    jst = jcr.train_step(jeng, js, jax_data.MicroBatchSpec(**spec))
    pst = pcr.train_step(peng, ps, pt_data.MicroBatchSpec(**spec))
    for k in ("loss", "grad_norm", "critic_loss"):
        np.testing.assert_allclose(pst[k], jst[k], rtol=1e-4, err_msg=k)
    _assert_weights_match(jeng, peng)


def test_decay_mask_covers_the_router_and_expert_leaves(tree):
    """AdamW decays every layer leaf, as the reference's stacked ``ndim >=
    2`` rule does; the router and the 3-D expert leaves are no
    exception."""
    mask = pt_engine.decay_mask(_port(tree))
    for lm in mask["layers"]:
        assert lm["mlp"] == {"router": True, "w_gate": True, "w_up": True,
                             "w_down": True}
    stacked = jax.tree.map(lambda a: a.ndim >= 2, tree)
    assert all(jax.tree_util.tree_leaves(stacked["layers"]["mlp"]))


# --------------------------------------------------------------------------- #
# entry points on the CPU
# --------------------------------------------------------------------------- #


def test_sft_entry_point_on_a_mixtral_checkpoint(tmp_path):
    """``apps.main sft`` on a tiny Mixtral HF directory written by the
    port's converter: two finite metrics lines and a committed save that
    loads back as Mixtral."""
    from areal_tpu_torch.apps import main
    from areal_tpu_torch.base import recover
    from areal_tpu_torch.models import hf as pt_hf

    _, pcfg = _cfgs()
    src = str(tmp_path / "mixtral")
    pt_hf.save_hf_checkpoint(_tree(), pcfg, "mixtral", src)
    rng = np.random.default_rng(0)
    data = tmp_path / "sft.jsonl"
    data.write_text("".join(json.dumps({
        "prompt_ids": rng.integers(1, 128, 4).tolist(),
        "answer_ids": rng.integers(1, 128, 5).tolist()}) + "\n"
        for _ in range(4)))
    args = ["sft", "experiment_name=moe-sft", "trial_name=t0",
            f"fileroot={tmp_path}/files", f"dataset.path={data}",
            "dataset.name=prompt_answer", f"model.path={src}",
            "hf_family=mixtral",
            "control.total_train_steps=2", "control.save_freq_steps=2",
            "batch_size=2", "max_tokens_per_mb=256", "trainer_device=cpu"]
    assert main.main(args) == 0
    logs = tmp_path / "files" / "logs" / "moe-sft" / "t0"
    lines = [json.loads(ln) for ln in open(logs / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [1, 2]
    assert all(np.isfinite(ln["sft/loss"]) for ln in lines)
    saves = [p.parent for p in tmp_path.glob("files/**/config.json")
             if p.parent != tmp_path / "mixtral"]
    assert saves, "no save"
    for d in saves:
        assert recover.read_manifest(str(d)) is not None
        cfg, host = pt_hf.load_hf_checkpoint(str(d))
        assert cfg.mlp_type == "moe" and cfg.moe.num_experts == 4
        # neither package's export writes router_aux_loss_coef, so the
        # reload reads the converter's default (ROADMAP queue 3)
        assert cfg.moe.aux_loss_coeff == 0.0
        assert host["layers"]["mlp"]["w_gate"].shape == (2, 4, 32, 48)


def test_profile_entry_point_counts_the_activated_flops(capsys):
    """``apps/profile.py`` on an MoE arch: its MFU divides the FLOPs of the
    ``top_k`` activated experts (``base/flops.py``), not of all of them,
    by the step time; ``--peak-flops`` 1e10 (a CPU scale) keeps the MFU
    readable at four decimals."""
    from areal_tpu_torch.apps import main
    from areal_tpu_torch.base import flops

    arch = dict(MODEL, moe=dict(MOE))
    peak = 1e10
    assert main.main(["profile", "--seqlens", "16x2", "--n-steps", "1",
                      "--device", "cpu", "--peak-flops", str(peak),
                      f"arch={json.dumps(arch)}"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "profile_step"
    assert np.isfinite(out["mfu"]) and 0 < out["mfu"] <= 1
    cfg = _cfgs()[1]
    assert out["n_params"] == flops.param_count(cfg)
    want = flops.train_flops(cfg, 32, seqlens=[16, 16])
    assert want < 6 * flops.param_count(cfg) * 32
    np.testing.assert_allclose(out["mfu"],
                               want / out["step_time_s"] / peak, rtol=0.02)
