"""Port parity: the fused LM-head + sampling epilogue of
``areal_tpu_torch`` against ``areal_tpu``.

(a) The plain version of the CUDA kernel (``fused_sample_plain``) against
    the TPU kernel in interpret mode, from the same numpy operands and the
    SAME seed (the one the JAX wrapper derives from its key): the uniforms
    are a pure function of (seed, row, column), so ``argmax`` and every
    token, sampled rows included, must be equal; floats to 1e-4 (float32
    sums in another order) plus 1e-6 of the row's ``norm``: a greedy row
    divides by the 1e-6 temperature floor, so its warped values and its
    norm are ~1e6, where one float32 ulp is 0.25 to 0.5.
(b) The streamed PyTorch path (top-k buffer) against ``_fused_sample_xla``:
    everything deterministic to 1e-4, top-k rows inside the top-k set,
    marginals by chi-square (the two draw from different random streams).
(c) The hash in int64 against the reference's uint32 arithmetic.
(d) The CUDA wrapper refuses what the kernel does not take, before any
    launch, and the dispatcher refuses top-k on the kernel.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from areal_tpu.ops import fused_sample as jax_fs
from areal_tpu.ops.pallas import fused_sample as jax_pk
from areal_tpu_torch.ops import fused_sample as pt_fs
from areal_tpu_torch.ops.cuda import fused_sample as cuda_fs

# chi-square threshold: df = 15 (16-token toy vocab), p ~ 1e-4
CHI2_CRIT = 45.0
N_DRAWS = 20000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tensors here are tiny, so torch's intra-op thread pool buys nothing;
    one pool per test worker crowds out the timing-sensitive tests that
    other workers run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(R=6, E=32, V=500, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, E)).astype(np.float32)
    w = (rng.normal(size=(E, V)) * 0.3).astype(np.float32)
    return x, w


def _jax_seed(key) -> np.ndarray:
    """The int32 seed ``fused_sample_pallas`` derives from its key."""
    return np.asarray(jax.random.randint(
        key, (1,), jnp.iinfo(jnp.int32).min, jnp.iinfo(jnp.int32).max,
        dtype=jnp.int32,
    ))


def _assert_floats_close(got, want, keys, rows=slice(None)):
    """|got - want| <= 1e-4 + 1e-6 * |norm| per row."""
    tol = 1e-4 + 1e-6 * np.abs(np.asarray(want["norm"]))[rows]
    for k in keys:
        diff = np.abs(got[k].numpy()[rows] - np.asarray(want[k])[rows])
        assert (diff <= tol).all(), (k, diff, tol)


TEMPS = np.array([0.0, 1.0, 0.7, 0.0, 1.3, 1.0], np.float32)

KERNEL_CASES = {
    "plain": dict(),
    "soft_cap": dict(soft_cap=5.0),
    "exclude_gather": dict(exclude=True, gather=True),
    "tied_head": dict(tied=True),
    "v130": dict(V=130),
    "v130_all": dict(V=130, soft_cap=3.0, exclude=True, gather=True,
                     tied=True),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_version_equals_the_tpu_kernel_in_interpret_mode(case):
    spec = dict(KERNEL_CASES[case])
    x, w = _problem(V=spec.pop("V", 500), seed=1)
    R, V = x.shape[0], w.shape[1]
    greedy = TEMPS <= 0.0
    key = jax.random.key(11)
    rng = np.random.default_rng(2)
    logits = x @ w
    # exclude the likeliest token of each row, so the exclusion binds
    exclude = (np.argmax(logits, -1).astype(np.int32)
               if spec.pop("exclude", False) else None)
    gather = (rng.integers(0, V, size=R).astype(np.int32)
              if spec.pop("gather", False) else None)
    tied = spec.pop("tied", False)
    soft_cap = spec.pop("soft_cap", None)
    want = jax_pk.fused_sample_pallas(
        key, jnp.asarray(x), jnp.asarray(w), jnp.asarray(TEMPS),
        jnp.asarray(greedy),
        exclude=None if exclude is None else jnp.asarray(exclude),
        gather_ids=None if gather is None else jnp.asarray(gather),
        soft_cap=soft_cap, block_v=128, interpret=True,
    )
    wt = torch.from_numpy(w)
    if tied:                       # embed.T: a view with E contiguous
        wt = wt.T.contiguous().T
        assert wt.stride(0) == 1
    got = pt_fs.fused_sample_plain(
        torch.from_numpy(_jax_seed(key).copy()), torch.from_numpy(x), wt,
        torch.from_numpy(TEMPS), torch.from_numpy(greedy),
        exclude=None if exclude is None else torch.from_numpy(exclude),
        gather_ids=None if gather is None else torch.from_numpy(gather),
        soft_cap=soft_cap, block_v=128,
    )
    assert set(got) == set(want)
    for k in ("tokens", "argmax"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
    _assert_floats_close(got, want, set(want) - {"tokens", "argmax"})
    if exclude is not None:
        sampled = ~greedy
        assert (got["tokens"].numpy()[sampled] != exclude[sampled]).all()


def test_block_size_does_not_change_the_draw():
    """The stream is a function of (seed, row, column) only."""
    x, w = _problem(seed=3)
    args = (torch.tensor([-77], dtype=torch.int32), torch.from_numpy(x),
            torch.from_numpy(w), torch.from_numpy(TEMPS),
            torch.from_numpy(TEMPS <= 0.0))
    a = pt_fs.fused_sample_plain(*args, block_v=64)
    b = pt_fs.fused_sample_plain(*args, block_v=500)
    c = pt_fs.fused_sample(*args)          # CPU tensors: the plain version
    for k in a:
        if a[k].dtype == torch.int32:
            assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k
    _assert_floats_close(a, {k: v.numpy() for k, v in b.items()},
                         ("logprobs", "norm"))


def test_streamed_path_vs_the_reference_xla_path():
    x, w = _problem(seed=4)
    R, V = x.shape[0], w.shape[1]
    greedy = TEMPS <= 0.0
    topk = np.array([1 << 30, 5, 1 << 30, 1 << 30, 3, 100], np.int32)
    gather = (np.arange(R) * 7).astype(np.int32)
    want = jax_fs.fused_sample(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(w), jnp.asarray(TEMPS),
        jnp.asarray(greedy), soft_cap=8.0, topk=jnp.asarray(topk),
        gather_ids=jnp.asarray(gather), block_size=64, use_pallas=False,
    )
    logits = np.tanh((x @ w) / 8.0) * 8.0
    for seed in range(8):
        got = pt_fs.fused_sample(
            torch.tensor([seed], dtype=torch.int32), torch.from_numpy(x),
            torch.from_numpy(w), torch.from_numpy(TEMPS),
            torch.from_numpy(greedy), soft_cap=8.0,
            topk=torch.from_numpy(topk), gather_ids=torch.from_numpy(gather),
            block_size=64,
        )
        np.testing.assert_array_equal(got["argmax"].numpy(),
                                      np.asarray(want["argmax"]))
        np.testing.assert_array_equal(got["tokens"].numpy()[greedy],
                                      np.asarray(want["tokens"])[greedy])
        _assert_floats_close(got, want, ("norm", "gathered_lp"))
        _assert_floats_close(got, want, ("logprobs",), rows=greedy)
        tok, lp = got["tokens"].numpy(), got["logprobs"].numpy()
        for r in (1, 4):            # active top-k rows stay in their set
            top_ids = np.argsort(-logits[r])[: topk[r]]
            assert tok[r] in top_ids
            z = logits[r, top_ids] / TEMPS[r]
            want_lp = logits[r, tok[r]] / TEMPS[r] - (
                z.max() + np.log(np.exp(z - z.max()).sum()))
            np.testing.assert_allclose(lp[r], want_lp, atol=1e-4)
        # top_k 100 is past the buffer: the row samples the full vocabulary
        warped = logits[5] / TEMPS[5]
        np.testing.assert_allclose(
            lp[5], warped[tok[5]] - np.asarray(want["norm"])[5], atol=1e-4)


def _chi2(counts, p):
    n = counts.sum()
    mask = p > 0
    return float((((counts[mask] - n * p[mask]) ** 2) / (n * p[mask])).sum())


def _marginal(**kw):
    """First-token counts over N_DRAWS seeds: the draws of one call with
    N_DRAWS identical rows are independent, because the row index enters
    the hash like the seed does."""
    x, w = _problem(R=1, E=8, V=16, seed=5)
    rows = N_DRAWS
    out = pt_fs.fused_sample(
        torch.tensor([123], dtype=torch.int32),
        torch.from_numpy(np.repeat(x, rows, 0)), torch.from_numpy(w),
        torch.ones(rows), torch.zeros(rows, dtype=torch.bool),
        block_size=7, **{k: torch.full((rows,), v, dtype=torch.int32)
                         for k, v in kw.items()},
    )
    return (x @ w)[0], np.bincount(out["tokens"].numpy(), minlength=16)


def test_temperature_marginal():
    lg, counts = _marginal()
    p = np.exp(lg - lg.max())
    assert _chi2(counts, p / p.sum()) < CHI2_CRIT


def test_topk_marginal():
    k = 5
    lg, counts = _marginal(topk=k)
    keep = np.argsort(-lg)[:k]
    p = np.zeros_like(lg)
    p[keep] = np.exp(lg[keep] - lg[keep].max())
    assert counts[np.setdiff1d(np.arange(16), keep)].sum() == 0
    assert _chi2(counts, p / p.sum()) < CHI2_CRIT


def test_excluded_token_marginal():
    lg, _ = _marginal()
    ex = int(np.argmax(lg))
    _, counts = _marginal(exclude=ex)
    assert counts[ex] == 0
    p = np.exp(lg - lg.max())
    p[ex] = 0.0
    assert _chi2(counts.astype(float), p / p.sum()) < CHI2_CRIT


def _reference_uniform(seed, rows, cols):
    """The TPU kernel's hash, in numpy uint32 (wrap-around products)."""
    with np.errstate(over="ignore"):
        h = (cols.astype(np.int32) * np.int32(-1640531527)) \
            ^ (rows.astype(np.int32) * np.int32(-2048144789)) ^ np.int32(seed)
        h = h.view(np.uint32)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    return ((h >> np.uint32(8)).astype(np.float32) + np.float32(0.5)) \
        * np.float32(1.0 / (1 << 24))


@pytest.mark.parametrize("seed", [0, 1, -1, -2 ** 31, 2 ** 31 - 2, -123456789])
def test_hash_uniforms_equal_the_uint32_reference(seed):
    cols = np.concatenate([np.arange(300), 151936 - np.arange(1, 200),
                           [2 ** 31 - 1, 2 ** 30 + 12345]]).astype(np.int64)
    rows = np.array([0, 1, 31, 63, 159, 100000])[:, None]
    want = _reference_uniform(seed, rows, cols[None, :])
    got = pt_fs.hash_uniform(torch.tensor([seed], dtype=torch.int32),
                             torch.from_numpy(rows), torch.from_numpy(cols))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).all() and (want <= 1).all()


def test_hash_matches_the_jax_arithmetic():
    """The numpy reference above is the kernel's arithmetic: the same ops
    in jax.numpy give the same bits."""
    cols = jnp.arange(151900, 151936, dtype=jnp.int32)[None, :]
    rows = jnp.arange(4, dtype=jnp.int32)[:, None]
    seed = jnp.int32(-987654321)
    h = (cols * -1640531527) ^ (rows * -2048144789) ^ seed
    h = jax.lax.bitcast_convert_type(h, jnp.uint32)
    h = h ^ (h >> 16)
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    u = ((h >> 8).astype(jnp.float32) + 0.5) * (1.0 / (1 << 24))
    got = pt_fs.hash_uniform(torch.tensor([-987654321], dtype=torch.int32),
                             torch.arange(4)[:, None],
                             torch.arange(151900, 151936)[None, :])
    np.testing.assert_array_equal(got.numpy(), np.asarray(u))


def test_gumbel_noise_is_capped_where_the_uniform_rounds_to_one(monkeypatch):
    """The hash's top value gives u == 1 in float32 (in the reference's
    arithmetic too), where -log(-log(u)) is +inf; the port caps u one ulp
    below 1, so the noise stays finite and no column wins by default."""
    top = np.float32(2 ** 24 - 1)
    assert (top + np.float32(0.5)) * np.float32(2.0 ** -24) == np.float32(1.0)
    monkeypatch.setattr(pt_fs, "hash_uniform",
                        lambda seed, rows, cols: torch.ones(2, 3))
    g = pt_fs._gumbel(None, None, None)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), -np.log(-np.log1p(-2.0 ** -24)),
                               rtol=1e-6)
    assert np.float32(pt_fs.U_MAX) == np.float32(0.99999994) < 1.0


def _kernel_args(R=4, E=8, V=20, dtype=torch.float32):
    return dict(
        seed=torch.zeros(1, dtype=torch.int32),
        x=torch.zeros(R, E, dtype=dtype), w=torch.zeros(E, V, dtype=dtype),
        temperature=torch.ones(R), greedy=torch.zeros(R, dtype=torch.bool),
        exclude=None, gather_ids=None,
    )


def test_cuda_wrapper_rejects_cpu_tensors():
    a = _kernel_args()
    with pytest.raises(ValueError, match="unsupported device cpu"):
        cuda_fs.fused_sample(a["seed"], a["x"], a["w"], a["temperature"],
                             a["greedy"])
    assert cuda_fs.launches == 0


BAD_KERNEL_ARGS = {
    "float16": (lambda a: a.update(x=a["x"].half(), w=a["w"].half()),
                "float32 or both bfloat16"),
    "mixed_dtypes": (lambda a: a.update(w=a["w"].bfloat16()),
                     "float32 or both bfloat16"),
    "shape": (lambda a: a.update(w=torch.zeros(9, 20)), r"must be \[R, E\]"),
    "x_stride": (lambda a: a.update(x=torch.zeros(8, 4).T), "unit stride"),
    "w_strided_both": (lambda a: a.update(w=torch.zeros(8, 40)[:, ::2]),
                       "either V or E must be contiguous"),
    "tied_unaligned": (lambda a: a.update(x=torch.zeros(4, 6),
                                          w=torch.zeros(20, 6).T),
                       "multiples of 4"),
    "temperature_dtype": (lambda a: a.update(
        temperature=a["temperature"].double()), "temperature must be"),
    "greedy_dtype": (lambda a: a.update(greedy=a["greedy"].int()),
                     "greedy must be"),
    "exclude_dtype": (lambda a: a.update(exclude=torch.zeros(4).long()),
                      "exclude must be"),
    "gather_shape": (lambda a: a.update(
        gather_ids=torch.zeros(5, dtype=torch.int32)), "gather_ids must be"),
    "seed": (lambda a: a.update(seed=torch.zeros(1).long()),
             "seed must be one int32"),
}


@pytest.mark.parametrize("case", sorted(BAD_KERNEL_ARGS))
def test_cuda_wrapper_check_rejects(case):
    mutate, msg = BAD_KERNEL_ARGS[case]
    a = _kernel_args()
    mutate(a)
    with pytest.raises(ValueError, match=msg):
        cuda_fs._check(**a)


def test_cuda_wrapper_check_accepts_both_head_layouts():
    a = _kernel_args()
    assert cuda_fs._check(**a) is True
    a["w"] = torch.zeros(20, 8).T                 # tied: E contiguous
    assert cuda_fs._check(**a) is False
    a = _kernel_args(dtype=torch.bfloat16)
    a["w"] = torch.zeros(8, 64, dtype=torch.bfloat16)[:, :20]   # wider rows
    assert cuda_fs._check(**a) is True


def test_topk_with_the_kernel_requested_raises():
    a = _kernel_args()
    with pytest.raises(ValueError, match="top-k"):
        pt_fs.fused_sample(a["seed"], a["x"], a["w"], a["temperature"],
                           a["greedy"], topk=torch.full((4,), 4),
                           use_kernel=True)
    with pytest.raises(ValueError, match="does not match hidden"):
        pt_fs.fused_sample(a["seed"], a["x"], torch.zeros(9, 20),
                           a["temperature"], a["greedy"])
