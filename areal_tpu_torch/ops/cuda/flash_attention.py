"""Packed varlen flash attention: the hand-written CUDA kernels' wrappers.

``flash_forward`` ports ``areal_tpu/ops/pallas/flash_attention.py::
_flash_forward`` and ``flash_backward`` ports ``_flash_backward``; both
launch ``csrc/flash_attention.cu`` (the source says what bounds it and how
it is laid out) on the current stream for CUDA tensors and raise on
anything else. :class:`FlashAttention` is the ``torch.autograd.Function``
that pairs them, the counterpart of the ``custom_vjp`` ``_flash_thd``
(``flash_attention.py:1248-1287``). Their plain PyTorch version is
``ops/attention.py::attention_plain`` (gradients by autograd through it);
``packed_attention`` there picks one of the two by the tensors' device.
Nothing falls back from the kernels to the plain version.

Layout: the model's ``q [T, H, D]``, ``k``/``v`` ``[T, Hkv, D]``,
``segment_ids [T]`` (0 = padding); ``lse`` is ``[H, T]`` f32, natural log.
bf16 with head dim 64 or 128 runs the v4 tensor-core kernels (wgmma on
TMA-fed tiles); float32 and other head dims (multiples of 8 up to 256)
run the CUDA-core kernels of the same source.

Contract (the reference's band kernels, ``flash_attention.py:25-34``):
real segment ids are non-decreasing along the axis and padding (id 0)
sits at the tail, as ``train/batching.py::pack_sequences`` packs them. The
wrapper finds each token's segment start and end on the device with
``torch.searchsorted`` (no host sync); each kernel block derives its key
or query range from them. Input outside the contract gives wrong results,
not an error, exactly as in the reference.

The tensor-core kernels (v4) take their tiling from :func:`plan`, which
depends on ``(T, H, Hkv, D)`` only: ``bq`` tokens per consumer warpgroup
(the GQA group folded token-major into 64 rows), key tiles of
``key_tile`` from each block's key start, dk/dv blocks of ``block_k`` keys
walking query tiles of ``q_tile``, and the GQA group split over ``parts``
dk/dv blocks whose f32 partials (in a workspace this wrapper allocates)
the last block to arrive at a per-(key tile, kv head) int32 counter sums
in part order. The counters live in a zeroed buffer kept per device
(:func:`counters`); every launch leaves them at 0. ``q_range`` and
``k_range`` are the ranges each block derives on the device, in Python;
``ops/attention.py::attention_tiled`` mirrors the kernels' schedule and
arithmetic with them on the CPU.

``fwd_launches`` counts forward launches and ``bwd_launches`` backward
calls (each launches the dq and the dk/dv kernel), so a run can show that
its main path went through the kernels.
"""

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from areal_tpu_torch.ops.cuda import build

SOURCE = "areal_tpu_torch/csrc/flash_attention.cu"
REPLACES_FWD = "areal_tpu/ops/pallas/flash_attention.py:419"
REPLACES_BWD = "areal_tpu/ops/pallas/flash_attention.py:928"
MAX_D = 256     # largest head dim (kMaxD)
MAX_REP = 16    # query heads per kv head
ROWS = 64       # rows per consumer warpgroup (wgmma M)
KEY_TILE = 64   # forward and dq: keys per K/V tile
SMS = 132       # H100 SXM
TENSOR_CORE_D = (64, 128)  # bf16 head dims the v4 kernels take

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

fwd_launches = 0
bwd_launches = 0
_counters: Dict[torch.device, torch.Tensor] = {}


class FlashPlan(NamedTuple):
    n_rep: int      # query heads per kv head
    bq: int         # forward, dq: tokens per consumer warpgroup (64 // n_rep)
    block_q: int    # forward, dq: tokens per block (two warpgroups)
    key_tile: int   # forward, dq: keys per K/V tile
    block_k: int    # dk/dv: keys per block (64 per warpgroup)
    q_tile: int     # dk/dv: queries per Q/dO tile (48 at D 128: registers)
    parts: int      # dk/dv: blocks sharing one kv head's GQA group


def plan(T: int, H: int, Hkv: int, D: int) -> FlashPlan:
    """The v4 kernels' tiling for ``q [T, H, D]`` over ``Hkv`` kv heads.
    ``parts`` is the smallest divisor of ``n_rep`` that gives the dk/dv
    grid two blocks per SM (``n_rep`` when none does): more parts shorten
    the longest block's walk over the group's heads, at the cost of a
    workspace of ``parts x 2 x T x Hkv x D`` floats and a merge."""
    n_rep = H // Hkv
    bq = ROWS // n_rep
    block_k = 2 * ROWS
    blocks = -(-T // block_k) * Hkv
    parts = next((d for d in range(1, n_rep + 1)
                  if n_rep % d == 0 and blocks * d >= 2 * SMS), n_rep)
    q_tile = 48 if D > 64 else 64
    return FlashPlan(n_rep, bq, 2 * bq, KEY_TILE, block_k, q_tile, parts)


def q_range(seg, start, t0: int, n: int,
            window: Optional[int]) -> Tuple[int, int]:
    """Key range ``[lo, hi)`` of the real tokens among ``[t0, t0 + n)``, as
    each forward and dq block finds it on the device (``q_range`` in the
    source): from the segment (or window) start of the first to one past
    the last; ``(0, 0)`` when there is none. ``seg`` and ``start`` are
    host sequences (the ids and :func:`segment_bounds`' starts)."""
    T = len(seg)
    if t0 >= T or seg[t0] <= 0:
        return 0, 0
    tl = min(t0 + n, T) - 1
    last = tl if seg[tl] > 0 else int(start[tl]) - 1
    lo = int(start[t0])
    if window:
        lo = max(lo, t0 - window + 1)
    return lo, last + 1


def k_range(seg, start, end, k0: int, n: int, window: Optional[int]) -> int:
    """One past the last query that sees a real key among ``[k0, k0 + n)``
    (``k_range`` in the source): the segment (or window) end of the last
    real key; 0 when there is none."""
    T = len(seg)
    if k0 >= T or seg[k0] <= 0:
        return 0
    tl = min(k0 + n, T) - 1
    last = tl if seg[tl] > 0 else int(start[tl]) - 1
    hi = int(end[last])
    if window:
        hi = min(hi, last + window)
    return hi


def q_schedule(seg, start, sp: FlashPlan, window: Optional[int]):
    """The forward and dq kernels' walk (the same for every kv head): for
    each consumer warpgroup, ``(t0, n, tiles)``: its tokens ``[t0, t0 +
    n)`` (rows fold them with the group's heads) and the starts of the key
    tiles it computes, in order. A block's tiles run from the earlier of
    its two warpgroups' key starts in steps of ``key_tile``; a warpgroup
    skips those outside its own range."""
    T = len(seg)
    for q0 in range(0, T, sp.block_q):
        ranges = [q_range(seg, start, q0 + w * sp.bq, sp.bq, window)
                  for w in (0, 1)]
        live = [r for r in ranges if r[0] < r[1]]
        lo = min(r[0] for r in live) if live else 0
        hi = max(r[1] for r in live) if live else 0
        n_tiles = -(-(hi - lo) // sp.key_tile) if hi > lo else 0
        for w, (my_lo, my_hi) in enumerate(ranges):
            t0 = q0 + w * sp.bq
            if t0 >= T:
                continue
            tiles = [lo + i * sp.key_tile for i in range(n_tiles)]
            yield t0, min(sp.bq, T - t0), [
                k0 for k0 in tiles if k0 < my_hi and k0 + sp.key_tile > my_lo]


def k_schedule(seg, start, end, sp: FlashPlan, window: Optional[int]):
    """The dk/dv kernel's walk (the same for every kv head and every head
    of each part): for each consumer warpgroup, ``(kw0, n, tiles)``: its
    keys ``[kw0, kw0 + n)`` and the starts of the query tiles it computes,
    in order. A block's query tiles run from its first key in steps of
    ``q_tile`` to the later of its warpgroups' query ends."""
    T = len(seg)
    rows = sp.block_k // 2
    for k0 in range(0, T, sp.block_k):
        his = [k_range(seg, start, end, k0 + w * rows, rows, window)
               for w in (0, 1)]
        hi = max(his)
        n_qt = -(-(hi - k0) // sp.q_tile) if hi > k0 else 0
        for w in (0, 1):
            kw0 = k0 + w * rows
            if kw0 >= T:
                continue
            tiles = [k0 + j * sp.q_tile for j in range(n_qt)]
            yield kw0, min(rows, T - kw0), [
                qq for qq in tiles if qq < his[w] and qq + sp.q_tile > kw0]


def counters(device: torch.device, n: int = 0) -> torch.Tensor:
    """The device's dk/dv arrival counters (int32 zeros), grown to hold
    ``n``."""
    device = torch.device(device)
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def reset_launches() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


def _lib():
    lib = build.load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i32] * 4 + [f32, f32, i32]  # T H Hkv D scale cap window
        lib.flash_fwd.restype = i32
        lib.flash_fwd.argtypes = [i32] + [ptr] * 8 + dims + [ptr]
        lib.flash_bwd.restype = i32
        lib.flash_bwd.argtypes = [i32] + [ptr] * 15 + dims + [i32, ptr]
        for D in TENSOR_CORE_D:
            tiles = (ctypes.c_int * 4)()
            lib.flash_tiles(D, tiles)
            sp = plan(1, 1, 1, D)
            want = (ROWS, sp.key_tile, sp.block_k, sp.q_tile)
            if tuple(tiles) != want:
                raise RuntimeError(f"flash attention: the kernels' tiles at D "
                                   f"{D} {tuple(tiles)} differ from plan()'s "
                                   f"{want}")
    return lib


def check_inputs(q, k, v, segment_ids) -> None:
    """Raise ``ValueError`` on anything the kernels do not accept (shape,
    dtype, head dim, GQA group, alignment, device)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(
            f"flash attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} must be [T, H, D] and [T, Hkv, D]"
        )
    T, H, D = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (T, Hkv, D) or tuple(v.shape) != (T, Hkv, D):
        raise ValueError(f"flash attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if tuple(segment_ids.shape) != (T,):
        raise ValueError(f"flash attention: segment_ids "
                         f"{tuple(segment_ids.shape)} != ({T},)")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"flash attention: segment_ids must be integer, "
                         f"got {segment_ids.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash attention: dtype {q.dtype} unsupported "
                         "(float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention: q {q.dtype}, k {k.dtype}, v "
                         f"{v.dtype} must share one dtype")
    if D % 8 or D > MAX_D:
        raise ValueError(f"flash attention: head dim {D} must be a multiple "
                         f"of 8 and <= {MAX_D}")
    if Hkv == 0 or H % Hkv or H // Hkv > MAX_REP:
        raise ValueError(f"flash attention: {H} query heads over {Hkv} kv "
                         f"heads (need a multiple, at most {MAX_REP} each)")
    for name, t in (("q", q), ("k", k), ("v", v), ("segment_ids", segment_ids)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash attention: {name} on {t.device}; the "
                             "kernels take CUDA tensors on one device")


def segment_bounds(seg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per token, the first index of its segment and one past its last
    (int32, on the device). Padding maps past every real id, so the ids
    searched stay sorted under the contract."""
    key = torch.where(seg > 0, seg, torch.iinfo(torch.int32).max)
    start = torch.searchsorted(key, key, side="left", out_int32=True)
    end = torch.searchsorted(key, key, side="right", out_int32=True)
    return start, end


def _aligned(*ts) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("flash attention: tensors must be 16-byte aligned")


def _seg_int32(segment_ids: torch.Tensor) -> torch.Tensor:
    """int32, contiguous and 16-byte aligned (the kernels read it by TMA)."""
    seg = segment_ids.to(torch.int32).contiguous()
    return seg if seg.data_ptr() % 16 == 0 else seg.clone()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward(
    q: torch.Tensor,            # [T, H, D]
    k: torch.Tensor,            # [T, Hkv, D]
    v: torch.Tensor,            # [T, Hkv, D]
    segment_ids: torch.Tensor,  # [T], 0 = padding
    *,
    softmax_scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal packed attention on the card -> ``(out [T, H, D] in q's dtype,
    lse [H, T] f32)``; pad rows give out 0 and lse ``-2.38e38``."""
    global fwd_launches
    check_inputs(q, k, v, segment_ids)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg = _seg_int32(segment_ids)
    start, end = bounds if bounds is not None else segment_bounds(seg)
    T, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(H, T, dtype=torch.float32, device=q.device)
    _aligned(q, k, v, out)
    rc = _lib().flash_fwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr(), start.data_ptr(), end.data_ptr(), out.data_ptr(),
        lse.data_ptr(), T, H, k.shape[1], D,
        float(softmax_scale if softmax_scale is not None else D ** -0.5),
        float(soft_cap or 0.0), int(sliding_window or 0), _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    fwd_launches += 1
    return out, lse


def flash_backward(
    q, k, v, segment_ids, out, lse, dout, *,
    softmax_scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    bounds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FA2 gradients on the card: ``delta = rowsum(dO * O)`` in f32 by a
    small kernel (the reference leaves it to XLA,
    ``flash_attention.py:949-951``), then the dq kernel and the dk/dv kernel (the GQA group summed in registers
    within a block and, over ``plan().parts`` blocks, in part order).
    Returns ``(dq, dk, dv)`` in the inputs' dtype."""
    global bwd_launches
    check_inputs(q, k, v, segment_ids)
    T, H, D = q.shape
    if tuple(out.shape) != (T, H, D) or tuple(dout.shape) != (T, H, D):
        raise ValueError(f"flash attention: out {tuple(out.shape)} / dout "
                         f"{tuple(dout.shape)} != {(T, H, D)}")
    if tuple(lse.shape) != (H, T) or lse.dtype != torch.float32:
        raise ValueError(f"flash attention: lse {tuple(lse.shape)} "
                         f"{lse.dtype} must be ({H}, {T}) float32")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = out.to(q.dtype).contiguous()
    dout = dout.to(q.dtype).contiguous()
    lse = lse.contiguous()
    seg = _seg_int32(segment_ids)
    start, end = bounds if bounds is not None else segment_bounds(seg)
    delta = torch.empty(H, T, dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _aligned(q, k, v, out, dout, dq, dk, dv, lse, delta)
    Hkv = k.shape[1]
    sp = plan(T, H, Hkv, D)
    parts, ws, arrivals = 1, None, None
    if q.dtype == torch.bfloat16 and D in TENSOR_CORE_D:
        parts = sp.parts
        if parts > 1:
            ws = torch.empty(parts * 2 * T * Hkv * D, dtype=torch.float32,
                             device=q.device)
            arrivals = counters(q.device, -(-T // sp.block_k) * Hkv)
    rc = _lib().flash_bwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr(), start.data_ptr(), end.data_ptr(), lse.data_ptr(),
        out.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(),
        dv.data_ptr(), None if ws is None else ws.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(), T, H, Hkv, D,
        float(softmax_scale if softmax_scale is not None else D ** -0.5),
        float(soft_cap or 0.0), int(sliding_window or 0), parts, _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {rc}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``out = attention(q, k, v)`` whose forward and backward are the
    kernels; residuals are ``(q, k, v, segment bounds, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, softmax_scale, soft_cap,
                sliding_window):
        kw = dict(softmax_scale=softmax_scale, soft_cap=soft_cap,
                  sliding_window=sliding_window)
        check_inputs(q, k, v, segment_ids)
        seg = _seg_int32(segment_ids)
        bounds = segment_bounds(seg)
        out, lse = flash_forward(q, k, v, seg, bounds=bounds, **kw)
        ctx.save_for_backward(q, k, v, seg, *bounds, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, start, end, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, seg, out, lse, dout,
                                    bounds=(start, end), **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, segment_ids, *, softmax_scale=None,
                    soft_cap=None, sliding_window=None) -> torch.Tensor:
    """Differentiable packed attention on the card -> ``out [T, H, D]``."""
    return FlashAttention.apply(q, k, v, segment_ids, softmax_scale,
                                soft_cap, sliding_window)
