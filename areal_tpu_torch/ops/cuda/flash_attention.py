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
bf16 with head dim 64 or 128 runs on tensor cores; float32 and other head
dims (multiples of 8 up to 256) run the CUDA-core kernels of the same
source.

Contract (the reference's band kernels, ``flash_attention.py:25-34``):
real segment ids are non-decreasing along the axis and padding (id 0)
sits at the tail, as ``train/batching.py::pack_sequences`` packs them. The
wrapper finds each token's segment start and end on the device with
``torch.searchsorted`` (no host sync); each kernel block derives its key
or query range from them. Input outside the contract gives wrong results,
not an error, exactly as in the reference.

``fwd_launches`` counts forward launches and ``bwd_launches`` backward
calls (each launches the dq and the dk/dv kernel), so a run can show that
its main path went through the kernels.
"""

import ctypes
from typing import Optional, Tuple

import torch

from areal_tpu_torch.ops.cuda import build

SOURCE = "areal_tpu_torch/csrc/flash_attention.cu"
REPLACES_FWD = "areal_tpu/ops/pallas/flash_attention.py:419"
REPLACES_BWD = "areal_tpu/ops/pallas/flash_attention.py:928"
MAX_D = 256     # largest head dim (kMaxD)
MAX_REP = 16    # query heads per kv head

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

fwd_launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = 0
    bwd_launches = 0


def _lib():
    lib = build.load("flash_attention")
    if lib.flash_fwd.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i32] * 4 + [f32, f32, i32, ptr]  # T H Hkv D scale cap window stream
        lib.flash_fwd.restype = i32
        lib.flash_fwd.argtypes = [i32] + [ptr] * 8 + tail
        lib.flash_bwd.restype = i32
        lib.flash_bwd.argtypes = [i32] + [ptr] * 12 + tail
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
    seg = segment_ids.to(torch.int32).contiguous()
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
    """FA2 gradients on the card: ``delta = rowsum(dO * O)`` in PyTorch (as
    the reference leaves it to XLA, ``flash_attention.py:949-951``), then
    the dq kernel and the dk/dv kernel (dk/dv summed over the GQA group in
    registers). Returns ``(dq, dk, dv)`` in the inputs' dtype."""
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
    dout = dout.to(q.dtype).contiguous()
    lse = lse.contiguous()
    seg = segment_ids.to(torch.int32).contiguous()
    start, end = bounds if bounds is not None else segment_bounds(seg)
    delta = (dout.float() * out.float()).sum(-1).transpose(0, 1).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _aligned(q, k, v, dout, dq, dk, dv)
    rc = _lib().flash_bwd(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        seg.data_ptr(), start.data_ptr(), end.data_ptr(), lse.data_ptr(),
        dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), T, H, k.shape[1], D,
        float(softmax_scale if softmax_scale is not None else D ** -0.5),
        float(soft_cap or 0.0), int(sliding_window or 0), _stream(q),
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
        seg = segment_ids.to(torch.int32).contiguous()
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
