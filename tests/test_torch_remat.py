"""Port parity: the ``dots`` and ``dots_attn`` remat policies of
``areal_tpu_torch/models/transformer.py::forward_packed`` against the JAX
package's ``forward_packed`` under the same policy, on the CPU.

The tiny float32 model of ``tests/test_torch_train.py`` starts from the
JAX package's random params (carried across with ``params_from_numpy``);
one packed batch made with numpy from a seed goes through both. Compared:

- the output and every parameter gradient of a scalar loss, port against
  the reference under the same policy: rtol 1e-5, atol 1e-5 (the output)
  or 1e-5 of the leaf's largest gradient (float32 on both sides,
  summation order only; the embedding's gradient sums over tokens);
- the port's ``dots`` and ``dots_attn`` against its own ``full``: equal
  to the bit in float32 and with bfloat16 compute over float32 masters (the
  same ops on the same inputs; a remat policy only chooses what is saved);
- how often attention runs in one forward and backward, counted through
  ``ops.attention.attention_plain``: once per layer under ``dots_attn``
  and ``none``, twice under ``full`` and ``dots`` (the backward reruns
  it); and the 2-D matmuls that reach the kernels in the backward: the
  ``dots`` policies serve the forward's from what they saved, ``full``
  recomputes them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from areal_tpu.models import transformer as jax_tfm
from areal_tpu.models.config import ModelConfig as JaxConfig
from areal_tpu_torch.api import data as pt_data
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig as PtConfig
from areal_tpu_torch.ops import attention as pt_attn
from areal_tpu_torch.train import batching as pt_batching
from areal_tpu_torch.train import engine as pt_engine

MODEL = dict(n_layers=2, n_q_heads=4, n_kv_heads=2, head_dim=8,
             hidden_dim=32, intermediate_dim=64, vocab_size=128,
             dtype="float32", use_attention_bias=True)
POLICIES = ("full", "dots", "dots_attn", "none")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=3, n=6):
    """One packed row of ``n`` sequences of 5-20 random tokens."""
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(5, 21, size=n)]
    sample = pt_data.SequenceSample.from_default(
        ids=list(range(n)), seqlens=lens,
        data={"packed_input_ids": rng.integers(0, 128, sum(lens)
                                               ).astype(np.int64)})
    pb = pt_batching.pack_sequences(sample, n_rows=1)
    return tuple(pb.arrays[k][0] for k in ("input_ids", "segment_ids",
                                           "positions"))


def _weights(seed=3):
    """Loss weights over the ``[T, vocab]`` output: live rows only."""
    ids, seg, _ = _batch(seed)
    rng = np.random.default_rng(seed + 1)
    w = rng.normal(size=(ids.shape[0], MODEL["vocab_size"])).astype(np.float32)
    return w * (seg > 0)[:, None]


def _jax_params(seed=4):
    cfg = JaxConfig(**MODEL)
    rng = np.random.default_rng(seed)
    # noised so that no leaf keeps its trivial init (norm gains, biases)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.05, size=a.shape)
                   ).astype(np.float32),
        jax_tfm.init_params(cfg, jax.random.key(seed)))


def _jax_run(params, policy):
    cfg = JaxConfig(**dict(MODEL, remat_policy=policy))
    ids, seg, pos = _batch()
    w = _weights()

    def loss(p):
        out = jax_tfm.forward_packed(p, cfg, ids, seg, pos)
        return jnp.sum(out * w), out

    (val, out), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return (np.asarray(out), float(val),
            jax.device_get(grads))


def _pt_run(host_params, policy, **model_kw):
    cfg = PtConfig(**dict(MODEL, remat_policy=policy, **model_kw))
    params = pt_tfm.tree_map(lambda t: t.requires_grad_(True),
                             pt_tfm.params_from_numpy(host_params,
                                                      device="cpu"))
    ids, seg, pos = (torch.from_numpy(a) for a in _batch())
    out = pt_tfm.forward_packed(params, cfg, ids.long(), seg, pos)
    loss = (out * torch.from_numpy(_weights())).sum()
    loss.backward()
    grads = pt_tfm.params_to_numpy(pt_tfm.tree_map(lambda t: t.grad, params))
    return out.detach().numpy(), float(loss.detach()), grads


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("policy", ["dots", "dots_attn"])
def test_gradients_match_the_reference_under_the_same_policy(policy):
    host = _jax_params()
    want_out, want_loss, want_grads = _jax_run(host, policy)
    got_out, got_loss, got_grads = _pt_run(host, policy)
    live = _batch()[1] > 0
    np.testing.assert_allclose(got_out[live], want_out[live], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    want, got = _leaves(want_grads), _leaves(got_grads)
    assert set(want) == set(got)
    for k, w in want.items():
        assert np.abs(w).max() > 0, jax.tree_util.keystr(k)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k], np.asarray(w), atol=1e-5 * scale,
                                   rtol=1e-5, err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["dots", "dots_attn"])
def test_policies_give_full_remat_gradients_to_the_bit(policy, dtype):
    """bfloat16: f32 masters cast to bf16 inside each region, as the
    trainer runs them."""
    host = _jax_params()
    out0, loss0, grads0 = _pt_run(host, "full", dtype=dtype)
    out1, loss1, grads1 = _pt_run(host, policy, dtype=dtype)
    np.testing.assert_array_equal(out1, out0)
    assert loss1 == loss0
    g0, g1 = _leaves(grads0), _leaves(grads1)
    assert set(g0) == set(g1)
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k],
                                      err_msg=jax.tree_util.keystr(k))


class _CountMatmuls(TorchDispatchMode):
    """Counts the 2-D matmuls that reach the kernels while it is on (a
    matmul whose output a checkpoint policy saved is served from the
    cache and does not reach them)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(host, policy):
    cfg = PtConfig(**dict(MODEL, remat_policy=policy))
    params = pt_tfm.tree_map(lambda t: t.requires_grad_(True),
                             pt_tfm.params_from_numpy(host, device="cpu"))
    ids, seg, pos = (torch.from_numpy(a) for a in _batch())
    out = pt_tfm.forward_packed(params, cfg, ids.long(), seg, pos)
    loss = (out * torch.from_numpy(_weights())).sum()
    with _CountMatmuls() as mode:
        loss.backward()
    return mode.n


def test_attention_runs_and_matmuls_recomputed_per_policy(monkeypatch):
    """Attention forwards in one forward + backward, through a counted
    plain attention: ``dots_attn`` runs it once per layer, ``dots`` and
    ``full`` twice (the recompute reruns it)."""
    calls = [0]
    plain = pt_attn.attention_plain

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(pt_attn, "attention_plain", counted)
    host = _jax_params()
    L = MODEL["n_layers"]
    runs = {}
    for policy in POLICIES:
        calls[0] = 0
        _pt_run(host, policy)
        runs[policy] = calls[0]
    assert runs == {"full": 2 * L, "dots": 2 * L, "dots_attn": L, "none": L}
    # the backward's own matmuls (two per projection and the head's two),
    # plus, under full remat only, the recompute's forward matmuls: q, k,
    # v, o, gate and up (the recompute stops once it has what the backward
    # needs, before the down projection); the dots policies saved those
    mm = {p: _backward_matmuls(host, p) for p in POLICIES}
    assert mm["none"] == 2 * 7 * L + 2
    assert mm["dots"] == mm["dots_attn"] == mm["none"]
    assert mm["full"] - mm["none"] == 6 * L
    # without autograd every policy is one plain pass
    calls[0] = 0
    with torch.no_grad():
        for policy in POLICIES:
            cfg = PtConfig(**dict(MODEL, remat_policy=policy))
            pt_tfm.forward_packed(
                pt_tfm.params_from_numpy(host, device="cpu"), cfg,
                *(torch.from_numpy(a) for a in _batch()))
    assert calls[0] == len(POLICIES) * L


def test_engine_trains_under_each_policy_alike():
    """One SFT step of ``TrainEngine`` per policy: the same loss, grad
    norm and weights as under ``full``, to the bit."""
    from areal_tpu_torch.api.model import make_interface

    rng = np.random.default_rng(9)
    lens = [int(x) for x in rng.integers(6, 16, size=4)]
    sample = pt_data.SequenceSample.from_default(
        ids=list(range(4)), seqlens=lens,
        data={"packed_input_ids": rng.integers(0, 128, sum(lens)
                                               ).astype(np.int64),
              "prompt_mask": np.concatenate(
                  [np.r_[np.ones(2, bool), np.zeros(n - 2, bool)]
                   for n in lens])})
    host = _jax_params()
    sft = make_interface("sft")
    out = {}
    for policy in POLICIES:
        eng = pt_engine.TrainEngine(
            PtConfig(**dict(MODEL, remat_policy=policy, loss_chunk_size=16)),
            optimizer=pt_engine.OptimizerConfig(lr=1e-3), device="cpu",
        ).load_params(host).setup_optimizer(10)
        st = sft.train_step(eng, sample,
                            pt_data.MicroBatchSpec(max_tokens_per_mb=32))
        out[policy] = (st["loss"], st["grad_norm"],
                       pt_tfm.params_to_numpy(eng.params))
    for policy in ("dots", "dots_attn", "none"):
        assert out[policy][:2] == out["full"][:2], policy
        for a, b in zip(jax.tree_util.tree_leaves(out[policy][2]),
                        jax.tree_util.tree_leaves(out["full"][2])):
            np.testing.assert_array_equal(a, b)
