"""Port parity: the trainer slice of ``areal_tpu_torch`` against
``areal_tpu`` on the CPU.

A tiny float32 model (2 layers, 4/2 heads, D 8, hidden 32, vocab 128, as
``tests/test_ppo_interface.py``) starts from the JAX engine's random
params, handed to the port as numpy; both packages get the same
``SequenceSample`` contents, built with numpy from a seed. Compared:

- ``forward_packed`` logits and ``chunked_next_token_logprobs``: 1e-5
  (float32 both sides, summation order only);
- SFT ``train_batch``, two steps: loss and grad norm to rtol 1e-5; then
  the weights leaf by leaf through ``params_to_numpy`` to an atol of 1% of
  lr per step. Adam divides by sqrt(v), so summation-order noise in
  near-zero gradients grows up to ~lr in the update: a bound relative to
  the weights would be meaningless, one relative to lr is not;
- the weight-decay mask on the reference's stacked leaves, the
  finite-ness guard on an injected nan, a PPO actor round (decoupled loss,
  2 minibatches), a critic round, and packing / micro-batch splitting
  array for array.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from areal_tpu.api import data as jax_data
from areal_tpu.api import model as jax_model
from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu.train import batching as jax_batching
from areal_tpu.train import engine as jax_engine
from areal_tpu_torch.api import data as pt_data
from areal_tpu_torch.api import model as pt_model
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig
from areal_tpu_torch.parallel.mesh import ParallelConfig as PtParallel
from areal_tpu_torch.train import batching as pt_batching
from areal_tpu_torch.train import engine as pt_engine

MODEL = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
             hidden_dim=32, intermediate_dim=64, vocab_size=128,
             dtype="float32", use_attention_bias=True)
LR = 1e-3
W_ATOL = 0.01 * LR * 2       # 1% of lr per step, two steps
SPEC = dict(max_tokens_per_mb=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file does not crowd the
    timing-sensitive tests other workers run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rollout(seed, n_items=4, group=2):
    """numpy contents of a rollout batch: grouped sequences with prompt
    masks, token-aligned behaviour/reference logprobs, a reward per
    sequence."""
    rng = np.random.default_rng(seed)
    seqlens, ids, pm, lps = [], [], [], []
    for _ in range(n_items):
        inner = []
        for _ in range(group):
            plen, glen = int(rng.integers(2, 5)), int(rng.integers(3, 9))
            n = plen + glen
            inner.append(n)
            ids.append(rng.integers(0, 128, size=n).astype(np.int64))
            pm.append(np.r_[np.ones(plen, bool), np.zeros(glen, bool)])
            lp = np.zeros(n, np.float32)
            lp[plen - 1 : n - 1] = rng.normal(size=glen) * 0.1 - 1.0
            lps.append(lp)
        seqlens.append(inner)
    tok = dict(packed_input_ids=np.concatenate(ids),
               prompt_mask=np.concatenate(pm),
               packed_logprobs=np.concatenate(lps),
               packed_ref_logprobs=np.concatenate(lps) * 0.9)
    rewards = rng.normal(size=n_items * group).astype(np.float32)
    return seqlens, tok, rewards


def _sample(mod, seed, **kw):
    """One rollout as ``mod.SequenceSample`` (the JAX or the port class)."""
    seqlens, tok, rewards = _rollout(seed, **kw)
    keys = dict(tok, rewards=rewards,
                seq_no_eos_mask=np.zeros(len(rewards), bool))
    scalar = [[1] * len(inner) for inner in seqlens]
    return mod.SequenceSample(
        keys=set(keys), ids=list(range(len(seqlens))),
        seqlens={k: (scalar if k in ("rewards", "seq_no_eos_mask") else seqlens)
                 for k in keys},
        data={k: np.array(v) for k, v in keys.items()},
    )


def _engines(seed=0, is_critic=False, **model_kw):
    """A JAX engine and a port engine on the same initial params."""
    kw = dict(MODEL, is_critic=is_critic, **model_kw)
    jeng = jax_engine.TrainEngine(
        JaxConfig(**kw), optimizer=jax_engine.OptimizerConfig(lr=LR)
    ).init_random(seed)
    host = jax.device_get(jeng.params)
    peng = pt_engine.TrainEngine(
        PtConfig(**kw), optimizer=pt_engine.OptimizerConfig(lr=LR),
        device="cpu",
    ).load_params(host)
    return jeng.setup_optimizer(100), peng.setup_optimizer(100)


def _assert_weights_match(jeng, peng, atol=W_ATOL):
    want = jax.device_get(jeng.params)
    got = pt_tfm.params_to_numpy(peng.params)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        np.testing.assert_allclose(flat_g[path], np.asarray(w), atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(path))


def _assert_stats_match(jstats, pstats, rtol):
    assert set(jstats) == set(pstats), (set(jstats) ^ set(pstats))
    for k in jstats:
        np.testing.assert_allclose(pstats[k], jstats[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #


def test_forward_packed_and_chunked_logprobs_match():
    kw = dict(MODEL, loss_chunk_size=48)   # T 128: the chunk rounds down to 32
    jcfg, pcfg = JaxConfig(**kw), PtConfig(**kw)
    params = jax_tfm.init_params(jcfg, jax.random.key(4))
    pparams = pt_tfm.params_from_numpy(jax.device_get(params), device="cpu")
    pb = pt_batching.pack_sequences(_sample(pt_data, 5), n_rows=1)
    ids, seg, pos = (pb.arrays[k][0] for k in ("input_ids", "segment_ids",
                                               "positions"))
    assert ids.shape == (128,)
    want = jax_tfm.forward_packed(params, jcfg, ids, seg, pos)
    got = pt_tfm.forward_packed(pparams, pcfg, torch.from_numpy(ids),
                                torch.from_numpy(seg), torch.from_numpy(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    hidden_j = jax_tfm.forward_packed(params, jcfg, ids, seg, pos,
                                      with_head=False)
    want_lp = jax_tfm.chunked_next_token_logprobs(params, jcfg, hidden_j, ids,
                                                  seg, chunk=48)
    hidden_p = pt_tfm.forward_packed(pparams, pcfg, torch.from_numpy(ids),
                                     torch.from_numpy(seg),
                                     torch.from_numpy(pos), with_head=False)
    got_lp = pt_tfm.chunked_next_token_logprobs(
        pparams, pcfg, hidden_p, torch.from_numpy(ids), torch.from_numpy(seg),
        chunk=48,
    )
    np.testing.assert_allclose(got_lp.detach().numpy(), np.asarray(want_lp),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(  # the chunked path agrees with full logits
        got_lp.detach().numpy(),
        pt_engine.ppo_ops.gather_packed_shifted_log_probs(
            got, torch.from_numpy(ids), torch.from_numpy(seg)
        ).detach().numpy(), atol=1e-5, rtol=1e-5,
    )
    # the params survive the round trip to the JAX layout unchanged
    for a, b in zip(jax.tree_util.tree_leaves(pt_tfm.params_to_numpy(pparams)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


ARCHS = {
    "gpt2": dict(layer_norm_type="layer", mlp_type="fc", use_mlp_bias=True,
                 use_attn_proj_bias=True, apply_rotary=False,
                 abs_position_embedding=True, n_positions=128,
                 activation_function="gelu_new", tied_embedding=True),
    "gemma": dict(layer_norm_type="gemma", normalize_embed=True,
                  attn_logits_soft_cap=20.0, final_logits_soft_cap=10.0,
                  sliding_window=6, activation_function="gelu_pytorch_tanh",
                  tied_embedding=True),
    "critic": dict(is_critic=True),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_packed_architectures_match(arch):
    """The packed forward across the config switches it takes (layer norm,
    fc MLP, learned positions, soft caps, a sliding window, tied and
    critic heads), params noised so no leaf keeps its trivial init."""
    kw = dict(MODEL, **ARCHS[arch])
    jcfg, pcfg = JaxConfig(**kw), PtConfig(**kw)
    rng = np.random.default_rng(8)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.05, size=a.shape)
                   ).astype(np.float32),
        jax_tfm.init_params(jcfg, jax.random.key(8)),
    )
    pb = pt_batching.pack_sequences(_sample(pt_data, 15), n_rows=1)
    ids, seg, pos = (pb.arrays[k][0] for k in ("input_ids", "segment_ids",
                                               "positions"))
    want = jax_tfm.forward_packed(params, jcfg, ids, seg, pos)
    got = pt_tfm.forward_packed(pt_tfm.params_from_numpy(params, device="cpu"),
                                pcfg, torch.from_numpy(ids),
                                torch.from_numpy(seg), torch.from_numpy(pos))
    live = seg > 0
    np.testing.assert_allclose(got.detach().numpy()[live],
                               np.asarray(want)[live], atol=1e-5, rtol=1e-5)


def test_remat_policies():
    """``full``, ``dots`` and ``dots_attn`` checkpoint each layer and give
    the gradients of ``none`` (``tests/test_torch_remat.py`` holds the
    ``dots`` policies against the reference's)."""
    pb = pt_batching.pack_sequences(_sample(pt_data, 6), n_rows=1)
    arrays = {k: torch.from_numpy(v[0]) for k, v in pb.arrays.items()}
    grads = {}
    for policy in ("full", "dots", "dots_attn", "none"):
        cfg = PtConfig(**MODEL, remat_policy=policy)
        params = pt_tfm.tree_map(lambda t: t.requires_grad_(True),
                                 pt_tfm.init_params(cfg, seed=1, device="cpu"))
        out = pt_tfm.forward_packed(params, cfg, arrays["input_ids"].long(),
                                    arrays["segment_ids"], arrays["positions"])
        out.square().mean().backward()
        grads[policy] = [t.grad for t in pt_engine._leaves(params)]
    for policy in ("full", "dots", "dots_attn"):
        for a, b in zip(grads[policy], grads["none"]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    cfg = PtConfig(**MODEL, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        pt_tfm.forward_packed(pt_tfm.init_params(cfg, device="cpu"), cfg,
                              arrays["input_ids"].long(),
                              arrays["segment_ids"], arrays["positions"])


# --------------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------------- #


def test_sft_two_steps_match():
    from areal_tpu.interfaces.sft import sft_loss_fn as jax_sft
    from areal_tpu_torch.interfaces.sft import sft_loss_fn as pt_sft

    jeng, peng = _engines(seed=2)
    js, ps = _sample(jax_data, 7), _sample(pt_data, 7)
    jspec = jax_data.MicroBatchSpec(max_tokens_per_mb=32)
    pspec = pt_data.MicroBatchSpec(max_tokens_per_mb=32)
    for step in range(2):
        jst = jeng.train_batch(js, jspec, jax_sft)
        pst = peng.train_batch(ps, pspec, pt_sft)
        assert pst["n_mbs"] == jst["n_mbs"] > 1   # several micro-batches
        for k in ("loss", "grad_norm", "ppl", "n_tokens"):
            np.testing.assert_allclose(pst[k], jst[k], rtol=1e-5, err_msg=k)
        assert pst["lr"] == jst["lr"] == LR * step
    _assert_weights_match(jeng, peng)
    assert peng._step == 2


def test_weight_decay_mask_follows_the_stacked_layout():
    """With zero gradients Adam's update is 0, so only decay moves weights:
    every per-layer leaf (1-D norm gains and biases too, stacked [L, ...]
    in the reference) shrinks by (1 - lr * wd); final_ln does not."""
    jeng, peng = _engines(seed=3)

    def jax_zero(params, cfg, arrays):
        return sum(jnp.sum(x) for x in jax.tree_util.tree_leaves(params)) * 0.0, {}

    def pt_zero(params, cfg, arrays):
        return sum(t.sum() for t in pt_engine._leaves(params)) * 0.0, {}

    before = pt_tfm.params_to_numpy(peng.params)
    for _ in range(2):   # the first step runs at lr 0
        jeng.train_batch(_sample(jax_data, 8), jax_data.MicroBatchSpec(), jax_zero)
        peng.train_batch(_sample(pt_data, 8), pt_data.MicroBatchSpec(), pt_zero)
    after = pt_tfm.params_to_numpy(peng.params)
    shrink = 1.0 - LR * pt_engine.OptimizerConfig().weight_decay
    np.testing.assert_allclose(after["layers"]["ln1"]["weight"],
                               before["layers"]["ln1"]["weight"] * shrink,
                               rtol=1e-6)
    np.testing.assert_allclose(after["layers"]["attn"]["bq"],
                               before["layers"]["attn"]["bq"] * shrink,
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(after["final_ln"]["weight"],
                                  before["final_ln"]["weight"])
    _assert_weights_match(jeng, peng, atol=1e-7)


def test_guard_keeps_params_and_optimizer_state_on_nan():
    from areal_tpu.interfaces.sft import sft_loss_fn as jax_sft
    from areal_tpu_torch.interfaces.sft import sft_loss_fn as pt_sft

    def jax_nan(params, cfg, arrays):
        loss, st = jax_sft(params, cfg, arrays)
        return loss * jnp.nan, st

    def pt_nan(params, cfg, arrays):
        loss, st = pt_sft(params, cfg, arrays)
        return loss * float("nan"), st

    jeng, peng = _engines(seed=4)
    jspec, pspec = jax_data.MicroBatchSpec(), pt_data.MicroBatchSpec()
    jeng.train_batch(_sample(jax_data, 9), jspec, jax_sft)   # moments exist
    peng.train_batch(_sample(pt_data, 9), pspec, pt_sft)
    params = pt_tfm.params_to_numpy(peng.params)
    state = {id(p): {k: (v.clone() if torch.is_tensor(v) else v)
                     for k, v in s.items()}
             for p, s in peng.optimizer.state.items()}
    jst = jeng.train_batch(_sample(jax_data, 9), jspec, jax_nan)
    pst = peng.train_batch(_sample(pt_data, 9), pspec, pt_nan)
    assert jst["guard/step_ok"] == pst["guard/step_ok"] == 0.0
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(pt_tfm.params_to_numpy(peng.params))):
        np.testing.assert_array_equal(a, b)
    for p, s in peng.optimizer.state.items():
        for k, v in s.items():
            assert torch.equal(v, state[id(p)][k]), k
    # the next good step lands where the reference's does
    jeng.train_batch(_sample(jax_data, 9), jspec, jax_sft)
    pst = peng.train_batch(_sample(pt_data, 9), pspec, pt_sft)
    assert pst["guard/step_ok"] == 1.0
    _assert_weights_match(jeng, peng)


def test_engine_rejects_what_it_cannot_run():
    with pytest.raises(NotImplementedError, match="one device"):
        pt_engine.TrainEngine(PtConfig(**MODEL), PtParallel(data=2),
                              device="cpu")
    peng = pt_engine.TrainEngine(PtConfig(**MODEL, attn_max_seqlen=4),
                                 device="cpu").init_random(0)
    with pytest.raises(ValueError, match="attn_max_seqlen=4"):
        peng.forward(_sample(pt_data, 1), pt_data.MicroBatchSpec(),
                     lambda p, c, a: a["segment_ids"])


# --------------------------------------------------------------------------- #
# interfaces
# --------------------------------------------------------------------------- #


def test_ppo_actor_round_matches():
    hp = dict(ppo_n_minibatches=2, use_decoupled_loss=True, kl_ctl=0.05,
              use_adaptive_kl=True, adaptive_kl_target=0.01)
    jeng, peng = _engines(seed=5, loss_chunk_size=48)
    jact = jax_model.make_interface(
        "ppo_actor", hp=jax_model.PPOHyperparameters(**hp))
    pact = pt_model.make_interface(
        "ppo_actor", hp=pt_model.PPOHyperparameters(**hp))
    js, ps = _sample(jax_data, 10, n_items=6), _sample(pt_data, 10, n_items=6)
    js.update_(jact.inference(jeng, js, jax_data.MicroBatchSpec(**SPEC)))
    ps.update_(pact.inference(peng, ps, pt_data.MicroBatchSpec(**SPEC)))
    np.testing.assert_allclose(ps.data["prox_logp"], js.data["prox_logp"],
                               atol=1e-5, rtol=1e-5)
    ps.data["prox_logp"] = js.data["prox_logp"].copy()   # one input from here
    jst = jact.train_step(jeng, js, jax_data.MicroBatchSpec(**SPEC))
    pst = pact.train_step(peng, ps, pt_data.MicroBatchSpec(**SPEC))
    for k in ("advantages", "returns", "kl_rewards"):
        np.testing.assert_allclose(ps.data[k], js.data[k], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    _assert_stats_match(jst, pst, rtol=1e-4)
    assert peng.version == jeng.version == 1
    _assert_weights_match(jeng, peng)


def test_grpo_group_normalization_matches():
    hp = dict(ppo_n_minibatches=1, disable_value=True, group_adv_norm=True,
              adv_norm=False, use_decoupled_loss=False,
              recompute_logprob=False)
    jeng, peng = _engines(seed=6)
    jact = jax_model.make_interface(
        "ppo_actor", hp=jax_model.PPOHyperparameters(**hp))
    pact = pt_model.make_interface(
        "ppo_actor", hp=pt_model.PPOHyperparameters(**hp))
    js, ps = _sample(jax_data, 11, n_items=3), _sample(pt_data, 11, n_items=3)
    jst = jact.train_step(jeng, js, jax_data.MicroBatchSpec(**SPEC))
    pst = pact.train_step(peng, ps, pt_data.MicroBatchSpec(**SPEC))
    np.testing.assert_allclose(ps.data["advantages"], js.data["advantages"],
                               atol=1e-5, rtol=1e-5)
    _assert_stats_match(jst, pst, rtol=1e-4)


def test_ppo_critic_round_matches():
    hp = dict(ppo_n_minibatches=2)
    jeng, peng = _engines(seed=7, is_critic=True)
    jcr = jax_model.make_interface(
        "ppo_critic", hp=jax_model.PPOHyperparameters(**hp))
    pcr = pt_model.make_interface(
        "ppo_critic", hp=pt_model.PPOHyperparameters(**hp))
    js, ps = _sample(jax_data, 12), _sample(pt_data, 12)
    js.update_(jcr.inference(jeng, js, jax_data.MicroBatchSpec(**SPEC)))
    ps.update_(pcr.inference(peng, ps, pt_data.MicroBatchSpec(**SPEC)))
    np.testing.assert_allclose(ps.data["values"], js.data["values"],
                               atol=1e-5, rtol=1e-5)
    ps.data["values"] = js.data["values"].copy()
    jst = jcr.train_step(jeng, js, jax_data.MicroBatchSpec(**SPEC))
    pst = pcr.train_step(peng, ps, pt_data.MicroBatchSpec(**SPEC))
    np.testing.assert_allclose(ps.data["returns"], js.data["returns"],
                               atol=1e-5, rtol=1e-5)
    _assert_stats_match(jst, pst, rtol=1e-4)
    _assert_weights_match(jeng, peng)


# --------------------------------------------------------------------------- #
# packing
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_rows,capacity", [(1, None), (2, None), (3, 64)])
def test_packing_matches(n_rows, capacity):
    js, ps = _sample(jax_data, 13, n_items=5), _sample(pt_data, 13, n_items=5)
    jpb = jax_batching.pack_sequences(js, n_rows, capacity=capacity)
    ppb = pt_batching.pack_sequences(ps, n_rows, capacity=capacity)
    assert ppb.capacity == jpb.capacity and ppb.n_rows == jpb.n_rows
    assert [vars(p) for p in ppb.placements] == [vars(p) for p in jpb.placements]
    assert set(ppb.arrays) == set(jpb.arrays)
    for k, v in jpb.arrays.items():
        np.testing.assert_array_equal(ppb.arrays[k], v, err_msg=k)
        assert ppb.arrays[k].dtype == v.dtype, k
    assert (pt_batching.count_action_tokens(ppb)
            == jax_batching.count_action_tokens(jpb))


@pytest.mark.parametrize("n_mbs,budget", [(1, 40), (2, None), (3, 64)])
def test_split_into_micro_batches_matches(n_mbs, budget):
    js, ps = _sample(jax_data, 14, n_items=7), _sample(pt_data, 14, n_items=7)
    jparts = jax_batching.split_into_micro_batches(js, n_mbs, budget, 1)
    pparts = pt_batching.split_into_micro_batches(ps, n_mbs, budget, 1)
    assert len(pparts) == len(jparts)
    for jp, pp in zip(jparts, pparts):
        assert pp.ids == jp.ids and pp.seqlens == jp.seqlens
        for k in jp.keys:
            np.testing.assert_array_equal(pp.data[k], jp.data[k])
    with pytest.raises(ValueError, match="exceeds"):
        pt_batching.split_into_micro_batches(ps, 1, 4, 1)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_datapack_matches(k):
    from areal_tpu.base import datapack as jax_dp
    from areal_tpu_torch.base import datapack as pt_dp

    nums = np.random.default_rng(k).integers(1, 50, size=11).tolist()
    assert pt_dp.partition_balanced(nums, k) == jax_dp.partition_balanced(nums, k)
    assert (pt_dp.ffd_allocate(nums, 60, min_groups=k)
            == jax_dp.ffd_allocate(nums, 60, min_groups=k))
    x = np.arange(sum(nums))
    for a, b in zip(pt_dp.flat2seq(x, nums), jax_dp.flat2seq(x, nums)):
        np.testing.assert_array_equal(a, b)
