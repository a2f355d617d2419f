"""Port parity: the v4 flash kernels' tiling, mirrored on the CPU.

``ops/attention.py::attention_tiled`` and ``attention_tiled_backward``
follow the CUDA kernels' schedule (``ops/cuda/flash_attention.py::plan``,
``q_schedule``, ``k_schedule``): the GQA group folded token-major into
64-row warpgroups, key tiles from each block's key start, online softmax
with rescaling, and the dk/dv partials of each part of the group summed in
part order. They are held against the JAX package's flash attention, both
its Pallas kernels in interpret mode (as ``tests/test_flash_attention.py``
runs them) and its XLA reference ``_attention_xla``, on numpy inputs from a
seed, float32 on both sides: 2e-5 forward, 1e-4 gradients (summation order
only; the tolerances of ``tests/test_torch_flash_attention.py``). A
coverage test checks that the schedule visits every pair the mask keeps
exactly once, and no other.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
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
        seg[off:off + n] = i + 1
        off += n
    return q, k, v, do, seg


def _tiled(q, k, v, do, seg, scale, soft_cap, window, parts=None):
    t = [torch.from_numpy(a) for a in (q, k, v, do, seg)]
    out, lse = pt_attn.attention_tiled(t[0], t[1], t[2], t[4], scale, soft_cap,
                                       window)
    grads = pt_attn.attention_tiled_backward(
        t[0], t[1], t[2], t[4], out, lse, t[3], scale, soft_cap, window,
        parts=parts)
    return out.numpy(), lse.numpy(), *(g.numpy() for g in grads)


def _check_pad(out, lse, dq, seg):
    pad = seg == 0
    assert np.all(out[pad] == 0.0)
    assert np.all(lse[:, pad] == np.float32(pt_attn.NEG_INF))
    assert np.all(dq[pad] == 0.0)


# (H, Hkv, lens, soft cap, window, parts): n_rep 1, 3, 6 and 16; segments
# shorter than a 64-key tile, single tokens, lengths that divide no tile,
# a window that skips whole key tiles, a soft cap, a pad tail, and the
# GQA group split into 1, 2, 3 and 6 dk/dv parts
XLA_CASES = [
    (2, 2, [100, 90, 40], None, None, 1),          # n_rep 1, pad tail
    (6, 2, [130, 100, 3, 1], None, None, 3),       # n_rep 3, short + single
    (6, 1, [1, 1, 200, 1, 50], 5.0, None, 2),      # n_rep 6, cap, singles
    (6, 1, [250], None, 40, 6),                    # n_rep 6, window skips tiles
    (6, 1, [97, 61, 77], 20.0, 70, 1),             # n_rep 6, cap + window
    (16, 1, [180, 70], None, None, 4),             # n_rep 16
]


@pytest.mark.parametrize("D", [16, 128])  # 128: dk/dv query tiles of 48
@pytest.mark.parametrize("H,Hkv,lens,soft_cap,window,parts", XLA_CASES)
def test_tiled_mirror_matches_xla_reference(H, Hkv, lens, soft_cap, window,
                                            parts, D):
    T = 256
    q, k, v, do, seg = _inputs(len(lens) * 13 + H, T, H, Hkv, D, lens)
    scale = D ** -0.5
    out, lse, dq, dk, dv = _tiled(q, k, v, do, seg, scale, soft_cap, window,
                                  parts)

    def ref(q, k, v):
        return _attention_xla(q, k, v, jnp.asarray(seg), scale, soft_cap,
                              window)

    want, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out, np.asarray(want), **FWD_TOL)
    # lse against the port's plain version (the XLA branch returns none)
    plain_lse = pt_attn.attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, seg)), scale, soft_cap,
        window)[1].numpy()
    np.testing.assert_allclose(lse, plain_lse, **FWD_TOL)
    for got, exp in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got, np.asarray(exp), **GRAD_TOL)
    _check_pad(out, lse, dq, seg)


@pytest.mark.parametrize("parts", [1, 2, 3, 6])
def test_tiled_parts_sum_in_part_order(parts):
    """Every split of a GQA group of 6 gives the same gradients, within
    summation order of the reference's."""
    T, H, Hkv, D = 200, 6, 1, 16
    q, k, v, do, seg = _inputs(parts, T, H, Hkv, D, [120, 64, 3])
    scale = D ** -0.5
    _, _, dq, dk, dv = _tiled(q, k, v, do, seg, scale, None, None, parts)

    def ref(q, k, v):
        return _attention_xla(q, k, v, jnp.asarray(seg), scale, None, None)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, exp in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got, np.asarray(exp), **GRAD_TOL)


@pytest.mark.skipif(
    not compat.compiler_params_available(),
    reason="installed jax lacks pltpu CompilerParams/TPUCompilerParams",
)
@pytest.mark.parametrize(
    "H,Hkv,lens,soft_cap,window",
    [
        (2, 1, [50, 1, 40], None, None),       # n_rep 2, single token, pad
        (6, 2, [60, 3, 60], 5.0, 24),          # n_rep 3, cap, window
    ],
)
def test_tiled_mirror_matches_pallas_kernels(H, Hkv, lens, soft_cap, window):
    """The reference's Pallas kernels (interpret mode, block 128): out, lse
    from ``_flash_forward`` and gradients through the custom vjp."""
    T, D = 128, 8
    q, k, v, do, seg = _inputs(7 + H, T, H, Hkv, D, lens)
    scale = D ** -0.5
    out, lse, dq, dk, dv = _tiled(q, k, v, do, seg, scale, soft_cap, window)

    def flash(q, k, v):
        return jax_flash.packed_flash_attention(
            q, k, v, jnp.asarray(seg), softmax_scale=scale, soft_cap=soft_cap,
            sliding_window=window, block_size=128)

    want, vjp = jax.vjp(flash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, want_lse = jax_flash._flash_forward(
        jnp.asarray(q).swapaxes(0, 1), jnp.asarray(k).swapaxes(0, 1),
        jnp.asarray(v).swapaxes(0, 1), jnp.asarray(seg), scale, soft_cap,
        window, 128, 128, None,
    )
    live = seg > 0
    np.testing.assert_allclose(out[live], np.asarray(want)[live], **FWD_TOL)
    np.testing.assert_allclose(lse[:, live], np.asarray(want_lse)[:, live],
                               **FWD_TOL)
    for got, exp in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got, np.asarray(exp), **GRAD_TOL)


def _mask(seg, window):
    T = len(seg)
    idx = np.arange(T)
    m = (seg[:, None] == seg[None, :]) & (seg[:, None] > 0)
    m &= idx[:, None] >= idx[None, :]
    if window:
        m &= idx[:, None] - idx[None, :] < window
    return m


@pytest.mark.parametrize(
    "T,n_rep,lens,window",
    [
        (256, 1, [100, 90, 40], None),
        (333, 3, [130, 100, 3, 1], None),
        (300, 6, [1, 1, 200, 1, 50], None),
        (250, 6, [250], 40),
        (1001, 16, [333, 1, 500, 97], 150),
        (8192, 6, chip_smoke.SLICE_LENS, None),
        # the dense prefill's rectangular batch: one segment of Sp tokens
        # per row, its padding tail inside (the sync_ppo phase's shape)
        (16384, 6, [512] * 32, None),
        (512, 6, [64] * 8, 6),
    ],
)
def test_schedule_covers_each_kept_pair_once(T, n_rep, lens, window):
    """For every block, the (query, key) pairs its tiles visit and leave
    unmasked are exactly the pairs the mask keeps, each once, on both
    sides: the forward / dq walk and the dk/dv walk. Their total equals
    ``chip_smoke.flash_pairs`` (the bound's count)."""
    seg = np.zeros(T, np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i + 1
        off += n
    sp = cuda_flash.plan(T, n_rep, 1, 128)
    start, end = (t.tolist() for t in cuda_flash.segment_bounds(
        torch.from_numpy(seg)))
    seg_l = seg.tolist()
    mask = _mask(seg, window) if T <= 1024 else None
    for side in ("q", "k"):
        hits = np.zeros((T, T), np.int32) if mask is not None else None
        total = 0
        if side == "q":
            walk = cuda_flash.q_schedule(seg_l, start, sp, window)
        else:
            walk = cuda_flash.k_schedule(seg_l, start, end, sp, window)
        for a0, n, tiles in walk:
            size = sp.key_tile if side == "q" else sp.q_tile
            for b0 in tiles:
                rows = np.arange(a0, a0 + n)
                cols = np.arange(b0, min(b0 + size, T))
                t, kt = (rows[:, None], cols[None]) if side == "q" else \
                    (cols[None], rows[:, None])
                # the kernels' own masks: the keys each query row sees
                # (forward, dq), the queries each key row is seen by (dk/dv)
                if side == "q":
                    lo = np.array([
                        pt_attn._visible_from(seg_l, start, int(x), window)
                        if seg_l[x] > 0 else T + 1 for x in rows])[:, None]
                    ok = (kt >= lo) & (kt <= t)
                else:
                    hi = np.array([
                        (min(end[x], x + window) if window else end[x])
                        if seg_l[x] > 0 else x for x in rows])[:, None]
                    ok = (t >= kt) & (t < hi)
                total += int(ok.sum())
                if hits is not None:
                    qi, ki = np.broadcast_arrays(t, kt)
                    np.add.at(hits, (qi[ok], ki[ok]), 1)
        if hits is not None:
            assert np.array_equal(hits, mask.astype(np.int32)), side
        assert total == chip_smoke.flash_pairs(seg, window), side


def test_plan_at_the_slice_shape():
    sp = cuda_flash.plan(8192, 12, 2, 128)
    assert sp == cuda_flash.FlashPlan(n_rep=6, bq=10, block_q=20, key_tile=64,
                                      block_k=128, q_tile=48, parts=3)
    assert cuda_flash.plan(8192, 12, 2, 64).q_tile == 64
    # 64 key blocks x 2 kv heads x 3 parts: two blocks per SM
    assert -(-8192 // sp.block_k) * 2 * sp.parts >= 2 * cuda_flash.SMS
    assert cuda_flash.plan(256, 16, 1, 64).parts == 16   # no split suffices
    assert cuda_flash.plan(65536, 4, 4, 64).parts == 1   # enough blocks
