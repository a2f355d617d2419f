"""Port parity: paged attention of ``areal_tpu_torch`` against ``areal_tpu``.

- decode: the port's plain version (and the dispatching entry point, which
  takes it for CPU tensors) against the Pallas kernel run in interpret
  mode, as ``tests/test_paged_engine.py`` runs it, and against the XLA
  gather branch. atol 2e-5: float32 on both sides, summation order only.
- chunked-prefill extend with ``skip_pool`` off and on, same tolerance.
- the KV scatter into the pool, raw and int8: bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from areal_tpu.models import transformer as jax_tfm
from areal_tpu.ops import paged_attention as jax_paged
from areal_tpu.ops.pallas import paged_attention as pl_paged
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.ops import paged_attention as pt_paged
from areal_tpu_torch.ops.cuda import paged_attention as pt_cuda_paged


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are tiny, so torch's intra-op thread pool buys nothing;
    one pool per test worker crowds out the timing-sensitive tests that
    other workers run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5
B, Hq, Hkv, D, PAGE, M, P, L = 4, 4, 2, 16, 8, 4, 20, 3
LENS = np.asarray([1, 9, 32, 0], np.int32)   # partial / multi-page / full / empty


def _decode_inputs(quant: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k_self = rng.normal(size=(B, Hkv, D)).astype(np.float32)
    v_self = rng.normal(size=(B, Hkv, D)).astype(np.float32)
    if quant:
        pool = rng.integers(-127, 128, size=(L, P, 2, Hkv, PAGE, D)).astype(
            np.int8
        )
        scales = rng.uniform(0.01, 0.05, size=(L, P, 2, Hkv, PAGE)).astype(
            np.float32
        )
    else:
        pool = rng.normal(size=(L, P, 2, Hkv, PAGE, D)).astype(np.float32)
        scales = None
    # pool pages in permuted order
    table = rng.permutation(P)[: B * M].reshape(B, M).astype(np.int32)
    return q, k_self, v_self, pool, table, scales


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize(
    "soft_cap,window,quant",
    [(None, None, False), (5.0, None, False), (None, 6, False),
     (None, None, True)],
)
def test_decode_matches_pallas_interpret_and_xla(soft_cap, window, quant):
    q, ks, vs, pool, table, scales = _decode_inputs(quant)
    layer = 1
    kw = dict(soft_cap=soft_cap, sliding_window=window)
    want_pl = pl_paged.decode(
        q, ks, vs, pool, jnp.int32(layer), table, LENS,
        scales=None if scales is None else jnp.asarray(scales), **kw,
    )
    want_xla = jax_paged.paged_decode_attention(
        q, ks, vs, pool, jnp.int32(layer), table, LENS, use_pallas=False,
        scales=None if scales is None else jnp.asarray(scales), **kw,
    )
    args = (_t(q), _t(ks), _t(vs), _t(pool), layer, _t(table), _t(LENS))
    got_plain = pt_paged.decode_plain(*args, scales=_t(scales), **kw)
    got_entry = pt_paged.paged_decode_attention(*args, scales=_t(scales), **kw)
    for got in (got_plain, got_entry):
        assert got.shape == (B, Hq, D) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want_pl), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_xla), atol=ATOL)


@pytest.mark.parametrize("window", [None, 3])
def test_decode_plain_matches_xla_narrowed_table(window):
    """The engine hands decode a column slice of its full table (a wider
    row stride); positions the slice cannot address are not read."""
    q, ks, vs, pool, table, _ = _decode_inputs(False, seed=3)
    lens = np.asarray([5, 16, 0, 11], np.int32)   # all within 2 pages
    want = jax_paged.paged_decode_attention(
        q, ks, vs, pool, jnp.int32(2), table[:, :2], lens, use_pallas=False,
        sliding_window=window,
    )
    narrowed = _t(table)[:, :2]
    assert narrowed.stride(0) == M
    got = pt_paged.paged_decode_attention(
        _t(q), _t(ks), _t(vs), _t(pool), 2, narrowed, _t(lens),
        sliding_window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_decode_wrapper_rejects_bad_devices_before_launching():
    q, ks, vs, pool, table, _ = _decode_inputs(False)
    args = [_t(q), _t(ks), _t(vs), _t(pool), 0, _t(table), _t(LENS)]
    before = pt_cuda_paged.launches
    # the kernel's wrapper takes CUDA tensors only
    for q in (args[0].to("meta"), args[0]):
        with pytest.raises(ValueError, match="device"):
            pt_cuda_paged.decode(q, *args[1:])
    # the entry point sends CPU tensors to the plain version, which never
    # counts as a launch
    pt_paged.paged_decode_attention(*args)
    assert pt_cuda_paged.launches == before


@pytest.mark.parametrize(
    "skip_pool,soft_cap,window,quant",
    [(False, None, None, False), (False, 4.0, 5, False),
     (False, None, None, True), (True, None, None, False),
     (True, 4.0, 3, False)],
)
def test_extend_matches_jax(skip_pool, soft_cap, window, quant):
    rng = np.random.default_rng(7)
    Bx, C = 3, 8
    q = rng.normal(size=(Bx, C, Hq, D)).astype(np.float32)
    kc = rng.normal(size=(Bx, C, Hkv, D)).astype(np.float32)
    vc = rng.normal(size=(Bx, C, Hkv, D)).astype(np.float32)
    _, _, _, pool, table, scales = _decode_inputs(quant, seed=8)
    table = table[:Bx]
    start = np.zeros(Bx, np.int32) if skip_pool else np.asarray(
        [0, 5, 17], np.int32
    )
    n_new = np.asarray([8, 3, 0], np.int32)
    kw = dict(soft_cap=soft_cap, sliding_window=window, kv_block=16,
              skip_pool=skip_pool)
    want = jax_paged.paged_extend_attention(
        q, kc, vc, pool, jnp.int32(1), table, start, n_new,
        scales=None if scales is None else jnp.asarray(scales), **kw,
    )
    got = pt_paged.paged_extend_attention(
        _t(q), _t(kc), _t(vc), _t(pool), 1, _t(table), _t(start), _t(n_new),
        scales=_t(scales), **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert not got[2].any()   # rows past n_new are zero


@pytest.mark.parametrize("quant", [False, True])
def test_scatter_chunk_kv_bit_exact(quant):
    rng = np.random.default_rng(11)
    Bx, C = 3, 5
    ks = rng.normal(size=(L, Bx, C, Hkv, D)).astype(np.float32)
    vs = rng.normal(size=(L, Bx, C, Hkv, D)).astype(np.float32)
    ks[0, 0, 0] = 0.0        # an all-zero row: its scale falls back to 1
    _, _, _, pool, table, scales = _decode_inputs(quant, seed=12)
    table = table[:Bx]
    positions = np.asarray(
        [[0, 1, 2, 3, 4], [7, 8, 9, 10, 11], [30, 31, 32, 33, 34]], np.int32
    )
    valid = np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 1, 0, 0, 0]],
                       bool)
    want = jax_tfm._scatter_chunk_kv(
        jax_tfm.PagedKVCache(
            pages=jnp.asarray(pool),
            scales=None if scales is None else jnp.asarray(scales),
        ),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(table),
        jnp.asarray(positions), jnp.asarray(valid),
    )
    cache = pt_tfm.PagedKVCache.from_pages(_t(pool), _t(scales))
    pt_tfm._scatter_chunk_kv(
        cache, _t(ks), _t(vs), _t(table), _t(positions), _t(valid)
    )
    np.testing.assert_array_equal(cache.pages.numpy(), np.asarray(want.pages))
    if quant:
        np.testing.assert_array_equal(
            cache.scales.numpy(), np.asarray(want.scales)
        )
    else:
        assert cache.scales is None and want.scales is None
