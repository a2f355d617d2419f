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


# --------------------------------------------------------------------------- #
# v3 (the wgmma pass): its choice, its schedule, and its reduction order
# --------------------------------------------------------------------------- #

def _pass_args(**over):
    """Operands of the serving layout: bf16, V contiguous, aligned."""
    a = dict(dtype=torch.bfloat16, v_contig=True, E=1536, V=151936,
             x_ld=1536, w_ld=151936, x_ptr=1 << 20, w_ptr=1 << 30)
    a.update(over)
    return a


PASS_CASES = {
    "serving": (dict(), "v3"),
    "small_widths": (dict(E=8, V=8, x_ld=8, w_ld=8), "v3"),
    "wide_rows": (dict(w_ld=152064, x_ld=2048), "v3"),
    "cuda_cores_asked": (dict(cuda_cores=True), "cuda_cores"),
    "float32": (dict(dtype=torch.float32), "cuda_cores"),
    "float16": (dict(dtype=torch.float16), "cuda_cores"),
    "tied_head": (dict(v_contig=False, w_ld=1536), "cuda_cores"),
    "e_odd": (dict(E=200 + 4, x_ld=204), "cuda_cores"),
    "v_odd": (dict(V=50257, w_ld=50257), "cuda_cores"),
    "x_stride": (dict(x_ld=1540), "cuda_cores"),
    "w_stride": (dict(w_ld=151940), "cuda_cores"),
    "x_unaligned": (dict(x_ptr=(1 << 20) + 8), "cuda_cores"),
    "w_unaligned": (dict(w_ptr=(1 << 30) + 2), "cuda_cores"),
}


@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_choose_pass_by_layout_dtype_stride_and_alignment(case):
    over, want = PASS_CASES[case]
    over = dict(over)
    cuda_cores = over.pop("cuda_cores", False)
    assert cuda_fs.choose_pass(cuda_cores=cuda_cores,
                               **_pass_args(**over)) == want


V3_REFUSALS = {
    "float32": (dict(dtype=torch.float32), "bf16"),
    "tied_head": (dict(v_contig=False), "V contiguous"),
    "e": (dict(E=1534), "E 1534 is not a multiple of 8"),
    "v": (dict(V=151937), "V 151937 is not a multiple of 8"),
    "x_ld": (dict(x_ld=1537), "x row stride"),
    "w_ld": (dict(w_ld=151939), "w row stride"),
    "x_ptr": (dict(x_ptr=4), "x is not 16-byte aligned"),
    "w_ptr": (dict(w_ptr=6), "w is not 16-byte aligned"),
}


@pytest.mark.parametrize("case", sorted(V3_REFUSALS))
def test_v3_refuses_what_it_cannot_take(case):
    over, msg = V3_REFUSALS[case]
    reason = cuda_fs.v3_unsupported(**_pass_args(**over))
    assert reason is not None and msg in reason, reason
    assert cuda_fs.v3_unsupported(**_pass_args()) is None


H100_SMS = 132


PLAN_CASES = {
    # R, V: bands, blocks per band
    "decode_r32": (32, 151936, 1, 132),
    "group_edge_r64": (64, 151936, 1, 132),
    "group_edge_r65": (65, 151936, 2, 66),
    "spec_k1_r128": (128, 151936, 2, 66),
    "spec_k4_r320": (320, 151936, 5, 26),
    "spec_k8_r576": (576, 151936, 9, 14),
    "r1025": (1025, 151936, 17, 7),
    "tiles_cap_v256": (32, 256, 1, 1),
    "tiles_cap_v264": (32, 264, 1, 2),
    "tiles_cap_v1000": (320, 1000, 5, 4),
    "v8": (1, 8, 1, 1),
    "more_bands_than_sms": (64 * 140, 151936, 140, 1),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_v3_plan_and_partial_sizing_at_tile_and_group_edges(case):
    R, V, bands, per_band = PLAN_CASES[case]
    p = cuda_fs.plan(R, V, H100_SMS)
    assert (p["bands"], p["per_band"]) == (bands, per_band)
    assert p["tiles"] == -(-V // cuda_fs.TILE_V3)
    assert p["blocks"] == bands * per_band
    assert p["slots"] == 2 * per_band
    assert p["records"] == p["slots"] * R
    # every row in one band; no more blocks than SMs (unless one per band)
    assert (bands - 1) * cuda_fs.GROUP_ROWS < R <= bands * cuda_fs.GROUP_ROWS
    assert p["blocks"] <= H100_SMS or per_band == 1
    assert per_band <= p["tiles"]


def _integer_problem(R, E, V, seed):
    """Integer-valued operands: every logit is an exact float32 sum in any
    order, so ties are real ties for the kernel, the plain version and the
    emulation alike (and frequent: the max of a row repeats)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, size=(R, E)).astype(np.float32)
    w = rng.integers(-2, 3, size=(E, V)).astype(np.float32)
    return x, w


def _merge_records(a, b, symmetric):
    """One step of fused_sample_merge_kernel: fold record b into a
    (sequential, a lane's own records) or merge two lanes (symmetric:
    the term of the smaller maximum added second)."""
    mn = torch.maximum(a["m"], b["m"])
    ta = a["l"] * torch.exp(a["m"] - mn)
    tb = b["l"] * torch.exp(b["m"] - mn)
    if symmetric:
        first = torch.where(a["m"] >= b["m"], ta, tb)
        second = torch.where(a["m"] >= b["m"], tb, ta)
        l = first + second
    else:
        l = ta + tb
    out = dict(m=mn, l=l)

    def beats(v, i, ov, oi):
        return (v > ov) | ((v == ov) & (i < oi))

    up = beats(b["am_v"], b["am_i"], a["am_v"], a["am_i"])
    out["am_v"] = torch.where(up, b["am_v"], a["am_v"])
    out["am_i"] = torch.where(up, b["am_i"], a["am_i"])
    up = beats(b["g_p"], b["g_i"], a["g_p"], a["g_i"])
    for k in ("g_p", "g_w", "g_i"):
        out[k] = torch.where(up, b[k], a[k])
    out["gat"] = torch.maximum(a["gat"], b["gat"])
    return out


def _identity(R):
    full = lambda v, dt: torch.full((R,), v, dtype=dt)  # noqa: E731
    return dict(m=full(pt_fs._MASK, torch.float32), l=full(0.0, torch.float32),
                am_v=full(pt_fs._MASK, torch.float32),
                am_i=full(0, torch.int64), g_p=full(pt_fs._MASK, torch.float32),
                g_w=full(0.0, torch.float32), g_i=full(0, torch.int64),
                gat=full(pt_fs._MASK, torch.float32))


def _emulate_v3(seed, x, w, temperature, greedy, exclude, gather_ids,
                soft_cap, per_band):
    """v3's reduction order in plain PyTorch: tiles of TILE_V3 columns
    dealt to the band's blocks in the static strided order (block q walks
    tiles q, q + per_band, ...), its n-th tile to warpgroup n % 2; each
    (block, warpgroup) worker carries its state through
    ``_update_block``, greedy rows skipping the Gumbel fold; then the
    merge kernel's order: worker records strided over 32 lanes, then the
    lanes' xor tree."""
    R, V = x.shape[0], w.shape[1]
    tile = cuda_fs.TILE_V3
    t = temperature.float().clamp_min(1e-6)
    n_tiles = -(-V // tile)
    slots = [_identity(R) for _ in range(2 * per_band)]
    excl = None if exclude is None else exclude.long()
    gath = None if gather_ids is None else gather_ids.long()
    for q in range(per_band):
        for n, k in enumerate(range(q, n_tiles, per_band)):
            s = slots[2 * q + n % 2]
            logits = x.float() @ w[:, k * tile:(k + 1) * tile].float()
            if soft_cap:
                logits = torch.tanh(logits / soft_cap) * soft_cap
            c = dict(s) if gath is not None else {
                kk: v for kk, v in s.items() if kk != "gat"}
            new = pt_fs._update_block(c, logits, k * tile, seed, t, excl,
                                      gath, pt_fs.TOPK_MAX)
            for kk in ("g_p", "g_w", "g_i"):
                new[kk] = torch.where(greedy, s[kk], new[kk])
            new.setdefault("gat", s["gat"])
            slots[2 * q + n % 2] = new
    lanes = [_identity(R) for _ in range(32)]
    for i, rec in enumerate(slots):
        lanes[i % 32] = _merge_records(lanes[i % 32], rec, symmetric=False)
    off = 16
    while off:
        lanes = [_merge_records(lanes[i], lanes[i ^ off], symmetric=True)
                 for i in range(32)]
        off //= 2
    st = lanes[0]
    norm = st["m"] + torch.log(st["l"])
    out = {"tokens": torch.where(greedy, st["am_i"], st["g_i"]).int(),
           "argmax": st["am_i"].int(), "norm": norm,
           "logprobs": torch.where(greedy, st["am_v"] / t - norm,
                                   st["g_w"] - norm)}
    if gath is not None:
        out["gathered_lp"] = st["gat"] - norm
    return out


EMULATION_CASES = {
    # per_band, V (ragged unless a multiple of 256), options
    "one_worker_pair": (1, 1000, {}),
    "three_blocks_ragged": (3, 1000, {}),
    "five_blocks": (5, 2600, dict(exclude=True, gather=True)),
    "a_warpgroup_idle": (2, 300, dict(soft_cap=9.0)),
    "exact_tiles": (4, 2048, dict(gather=True)),
    "forty_workers_two_per_lane": (20, 5200, dict(exclude=True)),
}


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_v3_reduction_order_equals_the_plain_version(case):
    per_band, V, opts = EMULATION_CASES[case]
    R, E = 12, 16
    x, w = _integer_problem(R, E, V, seed=per_band * 7 + V)
    temps = np.tile(TEMPS, 2)
    greedy = temps <= 0.0
    logits = x @ w
    # plant argmax ties across workers: row r's best column copied into a
    # later tile dealt to another block or warpgroup; the lowest must win
    tile = cuda_fs.TILE_V3
    n_tiles = -(-V // tile)
    planted = {}
    for r in range(0, R, 3):
        src = int(np.argmax(logits[r]))
        dst_tile = (src // tile + 1 + r % max(1, n_tiles - 1)) % n_tiles
        dst = min(dst_tile * tile + (src % tile), V - 1)
        if dst != src:
            w[:, dst] = w[:, src]
            planted[r] = (min(src, dst), max(src, dst))
    logits = x @ w
    rng = np.random.default_rng(9)
    kw = {}
    if opts.get("exclude"):
        kw["exclude"] = torch.from_numpy(np.argmax(logits, -1).astype(np.int32))
    if opts.get("gather"):
        kw["gather_ids"] = torch.from_numpy(
            rng.integers(0, V, size=R).astype(np.int32))
    seed = torch.tensor([1234567], dtype=torch.int32)
    args = (seed, torch.from_numpy(x), torch.from_numpy(w),
            torch.from_numpy(temps), torch.from_numpy(greedy))
    want = pt_fs.fused_sample_plain(*args, soft_cap=opts.get("soft_cap"),
                                    block_v=384, **kw)
    got = _emulate_v3(*args, kw.get("exclude"), kw.get("gather_ids"),
                      opts.get("soft_cap"), per_band)
    assert set(got) == set(want)
    for k in ("tokens", "argmax"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    _assert_floats_close(got, {k: v.numpy() for k, v in want.items()},
                         set(want) - {"tokens", "argmax"})
    # the planted ties resolve to the lower column, as a first max does
    first_max = np.argmax(logits if not opts.get("soft_cap") else
                          np.tanh(logits / opts["soft_cap"]), -1)
    np.testing.assert_array_equal(got["argmax"].numpy(), first_max)
    for r, (lo, hi) in planted.items():
        if logits[r, lo] == logits[r].max():
            assert int(got["argmax"][r]) == lo, (r, lo, hi)
    # greedy rows never read the Gumbel fields they skipped
    np.testing.assert_array_equal(got["tokens"].numpy()[greedy],
                                  got["argmax"].numpy()[greedy])


def test_v3_gumbel_threshold_keeps_every_column_that_can_win():
    """The kernel's fold takes the two accurate logs only for columns that
    pass u >= exp(-exp(warped - bar + lift)) - 1e-6, computed with the
    card's fast exponentials (relative error below 2^-21 each). Here the
    exponentials are perturbed by that much either way, and bar is set
    just above, at and below each column's exact perturbed value (float32
    warped - log(-log u), as the kernel and the plain version compute it):
    no column whose exact value reaches bar may fail the test."""
    rng = np.random.default_rng(0)
    n = 200000
    u = torch.from_numpy(rng.integers(0, 1 << 24, n).astype(np.int64))
    u = ((u.float() + 0.5) * (1.0 / (1 << 24))).clamp_max(pt_fs.U_MAX)
    u[:64] = pt_fs.U_MAX                       # the cap, and u near 1
    u[64:128] = float(np.float32(0.99999988))
    scale = torch.from_numpy(10.0 ** rng.uniform(-1, 6, n)).float()
    warped = torch.from_numpy(rng.normal(size=n)).float() * scale
    pert = warped - torch.log(-torch.log(u))
    rel = 2.0 ** -21
    for step in (-2, -1, 0, 1, 2):
        bar = pert + step * torch.finfo(torch.float32).eps * pert.abs()
        lift = 2e-5 + 2e-7 * bar.abs()
        for e1, e2 in ((1 + rel, 1 + rel), (1 - rel, 1 - rel),
                       (1 + rel, 1 - rel), (1 - rel, 1 + rel)):
            z = torch.exp(warped - bar + lift) * e1
            thr = torch.exp(-z) * e2 - 1e-6
            reach = pert >= bar
            assert bool((u[reach] >= thr[reach]).all()), step
    # and it does filter: far below the bar, columns are skipped
    bar = warped + 20.0
    thr = torch.exp(-torch.exp(warped - bar + 2e-5 + 2e-7 * bar.abs())) - 1e-6
    assert bool((u < thr).float().mean() > 0.999)
