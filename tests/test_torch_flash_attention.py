"""Port parity: packed flash attention of ``areal_tpu_torch`` against
``areal_tpu`` on the CPU.

The port's plain version ``attention_plain`` (out, lse, and dq/dk/dv by
autograd) is held against the reference's XLA branch ``_attention_xla``
and ``jax.grad`` through it, with lse against a float64 numpy
log-sum-exp; one case is held against the Pallas kernels themselves
(``packed_flash_attention`` and ``_flash_forward``, run in interpret mode
as ``tests/test_flash_attention.py`` runs them). Tolerances as that file:
2e-5 forward, 1e-4 gradients, float32 on both sides (summation order
only). The CUDA kernels cannot run here: their wrapper's input checks are
tested, and ``chip_smoke.py`` holds the kernels against
``attention_plain`` on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from areal_tpu.ops.attention import _attention_xla
from areal_tpu.ops.pallas import compat
from areal_tpu.ops.pallas import flash_attention as jax_flash
from areal_tpu_torch.ops import attention as pt_attn
from areal_tpu_torch.ops.cuda import flash_attention as cuda_flash

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file does not crowd the
    timing-sensitive tests other workers run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, T, H, Hkv, D, lens):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(T, H, D)).astype(np.float32)
    k = rng.normal(size=(T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(T, Hkv, D)).astype(np.float32)
    do = rng.normal(size=(T, H, D)).astype(np.float32)
    seg = np.zeros(T, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off : off + n] = i + 1
        off += n
    return q, k, v, do, seg


def _lse_reference(q, k, seg, scale, soft_cap, window):
    """float64 log-sum-exp of the masked scores, [H, T]; -2.38e38 on rows
    with no visible key."""
    T, H, D = q.shape
    rep = H // k.shape[1]
    kk = np.repeat(k.astype(np.float64), rep, axis=1)
    s = np.einsum("qhd,khd->hqk", q.astype(np.float64), kk) * scale
    if soft_cap is not None:
        s = soft_cap * np.tanh(s / soft_cap)
    idx = np.arange(T)
    mask = (seg[:, None] == seg[None, :]) & (seg[:, None] > 0)
    mask &= idx[:, None] >= idx[None, :]
    if window is not None:
        mask &= idx[:, None] - idx[None, :] < window
    s = np.where(mask[None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    live = mask.any(-1)
    with np.errstate(divide="ignore"):
        lse = m[..., 0] + np.log(
            np.exp(s - np.where(live[None, :, None], m, 0)).sum(-1))
    return np.where(live[None], lse, pt_attn.NEG_INF)


def _plain(q, k, v, do, seg, scale, soft_cap, window):
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = pt_attn.attention_plain(qt, kt, vt, torch.from_numpy(seg),
                                       scale, soft_cap, window)
    out.backward(torch.from_numpy(do))
    return (out.detach().numpy(), lse.detach().numpy(),
            *(t.grad.numpy() for t in (qt, kt, vt)))


@pytest.mark.parametrize(
    "H,Hkv,lens,soft_cap,window",
    [
        (4, 2, [100, 90, 40], None, None),       # segments + 26 pad tokens
        (6, 2, [130, 100], 5.0, None),           # soft cap, GQA 3
        (4, 4, [256], None, 32),                 # window, one segment, MHA
        (8, 1, [60, 120, 50], 20.0, 48),         # all at once, GQA 8
    ],
)
def test_attention_plain_matches_xla_reference(H, Hkv, lens, soft_cap, window):
    T, D = 256, 16
    q, k, v, do, seg = _inputs(len(lens) * 7 + H, T, H, Hkv, D, lens)
    scale = D ** -0.5
    out, lse, dq, dk, dv = _plain(q, k, v, do, seg, scale, soft_cap, window)

    def ref(q, k, v):
        return _attention_xla(q, k, v, jnp.asarray(seg), scale, soft_cap, window)

    want, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out, np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(
        lse, _lse_reference(q, k, seg, scale, soft_cap, window), **FWD_TOL
    )
    for got, exp in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got, np.asarray(exp), **GRAD_TOL)
    # pad rows: exactly 0 out, the sentinel lse, 0 gradient
    pad = seg == 0
    assert np.all(out[pad] == 0.0)
    assert np.all(lse[:, pad] == np.float32(pt_attn.NEG_INF))
    assert np.all(dq[pad] == 0.0)


@pytest.mark.skipif(
    not compat.compiler_params_available(),
    reason="installed jax lacks pltpu CompilerParams/TPUCompilerParams",
)
def test_attention_plain_matches_pallas_kernels():
    """The reference's Pallas kernels (interpret mode, block 128): out, lse
    from ``_flash_forward`` and gradients through the custom vjp."""
    T, H, Hkv, D = 128, 2, 1, 8
    q, k, v, do, seg = _inputs(11, T, H, Hkv, D, [50, 40])
    scale = D ** -0.5
    out, lse, dq, dk, dv = _plain(q, k, v, do, seg, scale, None, None)

    def flash(q, k, v):
        return jax_flash.packed_flash_attention(
            q, k, v, jnp.asarray(seg), softmax_scale=scale, block_size=128
        )

    want, vjp = jax.vjp(flash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, want_lse = jax_flash._flash_forward(
        jnp.asarray(q).swapaxes(0, 1), jnp.asarray(k).swapaxes(0, 1),
        jnp.asarray(v).swapaxes(0, 1), jnp.asarray(seg), scale, None, None,
        128, 128, None,
    )
    np.testing.assert_allclose(out, np.asarray(want), **FWD_TOL)
    np.testing.assert_allclose(lse, np.asarray(want_lse), **FWD_TOL)
    for got, exp in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got, np.asarray(exp), **GRAD_TOL)


def test_packed_attention_on_cpu_is_the_plain_version():
    q, k, v, _, seg = _inputs(3, 64, 4, 2, 8, [30, 20])
    args = [torch.from_numpy(a) for a in (q, k, v, seg)]
    got = pt_attn.packed_attention(*args, soft_cap=4.0, sliding_window=9)
    want = pt_attn.attention_plain(*args, 8 ** -0.5, 4.0, 9)[0]
    assert torch.equal(got, want)


def _good(T=32, H=4, Hkv=2, D=16, dtype=torch.float32):
    return (torch.zeros(T, H, D, dtype=dtype), torch.zeros(T, Hkv, D, dtype=dtype),
            torch.zeros(T, Hkv, D, dtype=dtype), torch.ones(T, dtype=torch.int32))


@pytest.mark.parametrize(
    "bad,match",
    [
        (lambda q, k, v, s: (q[0], k, v, s), r"must be \[T, H, D\]"),
        (lambda q, k, v, s: (q, k[:16], v, s), "do not match q"),
        (lambda q, k, v, s: (q, k, v, s[:5]), "segment_ids"),
        (lambda q, k, v, s: (q, k, v, s.float()), "must be integer"),
        (lambda q, k, v, s: (q.half(), k.half(), v.half(), s), "unsupported"),
        (lambda q, k, v, s: (q, k.bfloat16(), v, s), "share one dtype"),
        (lambda q, k, v, s: _good(D=12)[:3] + (s,), "multiple of 8"),
        (lambda q, k, v, s: _good(D=264)[:3] + (s,), "multiple of 8"),
        (lambda q, k, v, s: _good(H=6, Hkv=4)[:3] + (s,), "query heads"),
        (lambda q, k, v, s: _good(H=34, Hkv=2)[:3] + (s,), "query heads"),
        (lambda q, k, v, s: (q, k, v, s), "CUDA tensors"),
    ],
)
def test_cuda_wrapper_rejects_bad_input(bad, match):
    args = bad(*_good())
    with pytest.raises(ValueError, match=match):
        cuda_flash.flash_forward(*args)
    with pytest.raises(ValueError, match=match):
        cuda_flash.flash_backward(*args, args[0], torch.zeros(1), args[0])
    assert cuda_flash.fwd_launches == 0 and cuda_flash.bwd_launches == 0


def test_segment_bounds():
    seg = torch.tensor([1, 1, 1, 2, 3, 3, 0, 0], dtype=torch.int32)
    start, end = cuda_flash.segment_bounds(seg)
    assert start.tolist() == [0, 0, 0, 3, 4, 4, 6, 6]
    assert end.tolist() == [3, 3, 3, 4, 6, 6, 8, 8]
    assert start.dtype == end.dtype == torch.int32
