"""Port parity: the split-K arithmetic of the paged-decode kernel.

``decode_plain(pages_per_split=...)`` mirrors the CUDA kernel's split plan
(``ops/cuda/paged_attention.py::plan``): per-split partials ``(m, l, acc)``
merged in split order, then the self token. It is held against the JAX
package's ``decode`` (the Pallas kernel in interpret mode, as
``tests/test_torch_paged_attention.py`` runs it) and its XLA branch on the
same numpy inputs. atol 2e-5: float32 on both sides, summation order only.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from areal_tpu.ops import paged_attention as jax_paged
from areal_tpu.ops.pallas import paged_attention as pl_paged
from areal_tpu_torch.ops import paged_attention as pt_paged
from areal_tpu_torch.ops.cuda import paged_attention as pt_cuda_paged


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are tiny; one intra-op thread keeps this file from
    crowding the timing-sensitive tests other workers run beside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5
HKV, D, PAGE, M, L = 2, 16, 8, 7, 2     # width 7: splits of 2 and 3 pages
PAD = 3                                 # extra table columns (narrowed view)
P = 6 * (M + PAD)
# empty, one page, two pages (a 2-page split's end), three pages (a 3-page
# split's end), a partial last page, the whole table
LENS = (0, 8, 16, 24, 47, 56)
ONE_LONG = (0, 0, 0, 56, 0, 0)          # one long slot among empty ones


@functools.lru_cache(maxsize=None)
def _inputs(n_rep, quant, lens, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = rng.normal(size=(B, HKV * n_rep, D)).astype(np.float32)
    k_self = rng.normal(size=(B, HKV, D)).astype(np.float32)
    v_self = rng.normal(size=(B, HKV, D)).astype(np.float32)
    if quant:
        pool = rng.integers(-127, 128, size=(L, P, 2, HKV, PAGE, D)).astype(
            np.int8)
        scales = rng.uniform(0.01, 0.05, size=(L, P, 2, HKV, PAGE)).astype(
            np.float32)
    else:
        pool = rng.normal(size=(L, P, 2, HKV, PAGE, D)).astype(np.float32)
        scales = None
    # pool pages in permuted order; the kernel is handed the first M
    # columns of a wider table
    table = rng.permutation(P)[: B * (M + PAD)].reshape(B, M + PAD).astype(
        np.int32)
    return q, k_self, v_self, pool, table, scales, np.asarray(lens, np.int32)


@functools.lru_cache(maxsize=None)
def _jax_reference(n_rep, quant, lens, window, soft_cap):
    """(interpret-mode Pallas, XLA branch) outputs, computed once."""
    q, ks, vs, pool, table, scales, lens_np = _inputs(n_rep, quant, lens)
    kw = dict(soft_cap=soft_cap, sliding_window=window,
              scales=None if scales is None else jnp.asarray(scales))
    table = table[:, :M]
    want_pl = pl_paged.decode(q, ks, vs, pool, jnp.int32(1), table, lens_np,
                              **kw)
    want_xla = jax_paged.paged_decode_attention(
        q, ks, vs, pool, jnp.int32(1), table, lens_np, use_pallas=False, **kw)
    return np.asarray(want_pl), np.asarray(want_xla)


def _split_decode(n_rep, quant, lens, window, soft_cap, pages_per_split):
    q, ks, vs, pool, table, scales, lens_np = _inputs(n_rep, quant, lens)
    t = torch.from_numpy
    narrowed = t(table)[:, :M]
    assert narrowed.stride(0) == M + PAD
    return pt_paged.decode_plain(
        t(q), t(ks), t(vs), t(pool), 1, narrowed, t(lens_np),
        scales=None if scales is None else t(scales), soft_cap=soft_cap,
        sliding_window=window, pages_per_split=pages_per_split,
    )


def _check(n_rep, quant, lens, window=None, soft_cap=None, pps=1):
    want_pl, want_xla = _jax_reference(n_rep, quant, lens, window, soft_cap)
    got = _split_decode(n_rep, quant, lens, window, soft_cap, pps)
    assert got.shape == want_pl.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_pl, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL)
    return got


@pytest.mark.parametrize("pps", [1, 2, 3])
@pytest.mark.parametrize("quant", [False, True], ids=["f32_pool", "int8_pool"])
@pytest.mark.parametrize("n_rep", [1, 6, 8])
def test_split_mirror_matches_jax_decode(n_rep, quant, pps):
    """Lens 0, page and split boundaries, a narrowed table with a wider row
    stride, GQA groups of 1, 6 and 8, splits of 1, 2 and 3 (not dividing
    the width of 7) pages."""
    _check(n_rep, quant, LENS, pps=pps)


@pytest.mark.parametrize("pps", [1, 2, 3])
@pytest.mark.parametrize("quant", [False, True], ids=["f32_pool", "int8_pool"])
def test_split_mirror_one_long_slot_among_empty_ones(quant, pps):
    got = _check(6, quant, ONE_LONG, pps=pps)
    # an empty slot attends only itself: its output is its own V, repeated
    # over the GQA group
    q, ks, vs, *_ = _inputs(6, quant, ONE_LONG)
    want_self = np.repeat(vs[0][:, None], 6, axis=1).reshape(-1, D)
    np.testing.assert_allclose(got[0].numpy(), want_self, atol=1e-6)


@pytest.mark.parametrize("pps", [1, 2, 3])
@pytest.mark.parametrize("window", [10, 20])
def test_split_mirror_window_skips_whole_splits(window, pps):
    """At lens 47 and 56 a window of 10 or 20 leaves the first splits with
    nothing visible: they must merge as empty."""
    plan = pt_cuda_paged.plan(M, PAGE, pps)
    first_visible = 56 - window + 1
    assert first_visible // (plan.pages_per_split * PAGE) >= 1
    _check(6, False, LENS, window=window, pps=pps)


@pytest.mark.parametrize("pps", [2, 3])
def test_split_mirror_soft_cap_int8(pps):
    _check(8, True, LENS, window=30, soft_cap=5.0, pps=pps)


def test_split_mirror_equals_single_pass():
    """The default split (``SPLIT_TOKENS`` per split) against the one-pass
    plain version on the same tensors."""
    got = _split_decode(6, False, LENS, None, None, None)
    q, ks, vs, pool, table, _, lens = _inputs(6, False, LENS)
    t = torch.from_numpy
    want = pt_paged.decode_plain(t(q), t(ks), t(vs), t(pool), 1,
                                 t(table)[:, :M], t(lens))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("page", [1, 8, 16, 128, 256])
@pytest.mark.parametrize("pps", [None, 1, 2, 3, 5, 64])
def test_plan_covers_every_page_once(page, pps):
    for width in range(1, 41):
        plan = pt_cuda_paged.plan(width, page, pps)
        step = plan.pages_per_split
        covered = np.zeros(width, np.int64)
        for s in range(plan.n_splits):
            covered[s * step:min((s + 1) * step, width)] += 1
        assert (covered == 1).all(), (width, plan)
        # no split past the table
        assert (plan.n_splits - 1) * step < width
        want = max(1, pt_cuda_paged.SPLIT_TOKENS // page) if pps is None \
            else pps
        assert step == min(want, width)


def test_plan_takes_host_integers_only():
    """The grid follows from the table's width and the page size: the same
    plan whatever the slots' lengths, so a launch never reads ``lens``
    back from the device."""
    assert pt_cuda_paged.plan(16, 128) == (2, 8)
    assert pt_cuda_paged.plan(16, 128, 3) == (3, 6)
    assert pt_cuda_paged.plan(7, 16) == (7, 1)      # no wider than the table
    for bad in (0, -1):
        with pytest.raises(ValueError):
            pt_cuda_paged.plan(16, 128, bad)
    with pytest.raises(ValueError):
        pt_cuda_paged.plan(0, 128)
    assert pt_cuda_paged.plan(300, 1, 200) == (200, 2)
    # the wrapper sizes its launch from the table width: the same call with
    # any lens makes the same plan
    for lens in (LENS, ONE_LONG):
        *_, table, _, _ = _inputs(6, False, lens)
        assert pt_cuda_paged.plan(table[:, :M].shape[1], PAGE) == (M, 1)
