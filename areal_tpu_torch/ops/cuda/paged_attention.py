"""Paged decode attention: the hand-written CUDA kernel's wrapper.

``decode`` is the port of ``areal_tpu/ops/pallas/paged_attention.py::
decode`` (same arguments, same ``[B, Hq, D]`` result). It launches
``csrc/paged_decode.cu`` (the source says what bounds it and how it is
laid out) on the current stream for CUDA tensors and raises on anything
else. Its plain PyTorch version is ``ops/paged_attention.py::
decode_plain``; ``paged_decode_attention`` there picks one of the two by
the tensors' device. Nothing falls back from the kernel to the plain
version.

The kernel splits each slot's table into runs of ``pages_per_split``
pages (``plan``: the grid follows from the table width alone, never from
``lens``, so a launch needs no host sync), writes one f32 partial per
split into a workspace this wrapper allocates, and merges the splits in
the same launch through a per-(slot, kv head) arrival counter. The
counters live in a zeroed int32 buffer kept per device (``counters``);
every launch leaves them at 0.

``launches`` counts launches the card ran, so a run can show that its
main path went through the kernel: an eager call adds one; a call under
CUDA graph capture adds one to ``captured`` instead, and whoever replays
the graph adds what its capture recorded (``credit``). The arrival
counters must be grown (``counters``) before a capture: a buffer made
under capture would belong to the graph's memory pool.
"""

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from areal_tpu_torch.ops.cuda import build

SOURCE = "areal_tpu_torch/csrc/paged_decode.cu"
REPLACES = "areal_tpu/ops/pallas/paged_attention.py:291"
MAX_REP = 16   # query heads per kv head the kernel holds (kMaxRep)
MAX_D = 256    # largest head dim (kMaxD)
SPLIT_TOKENS = 256   # default split: this many positions' worth of pages

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launches = 0
captured = 0
_counters: Dict[torch.device, torch.Tensor] = {}


class SplitPlan(NamedTuple):
    pages_per_split: int
    n_splits: int


def plan(width: int, page: int,
         pages_per_split: Optional[int] = None) -> SplitPlan:
    """How the kernel (and ``decode_plain``'s split mirror) cuts a table of
    ``width`` columns: split ``s`` takes columns ``[s * pages_per_split,
    min((s + 1) * pages_per_split, width))``. The default puts
    ``SPLIT_TOKENS`` positions in a split (two pages at page 128); a split
    never holds more columns than the table has. Depends on host integers
    only."""
    if pages_per_split is None:
        pages_per_split = max(1, SPLIT_TOKENS // page)
    if pages_per_split < 1 or width < 1 or page < 1:
        raise ValueError(f"paged decode: no split plan for width {width}, "
                         f"page {page}, {pages_per_split} pages per split")
    pages_per_split = min(int(pages_per_split), width)
    return SplitPlan(pages_per_split, -(-width // pages_per_split))


def counters(device: torch.device, n: int = 0) -> torch.Tensor:
    """The device's arrival counters (int32 zeros), grown to hold ``n``."""
    device = torch.device(device)
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def reset_launches() -> None:
    global launches
    launches = 0


def _count_launch() -> None:
    """One launch of the kernel: run now, or recorded into a CUDA graph
    under capture (it runs when the graph replays; see ``credit``)."""
    global launches, captured
    if torch.cuda.is_current_stream_capturing():
        captured += 1
    else:
        launches += 1


def credit(n: int) -> None:
    """Count ``n`` launches that a replayed CUDA graph ran: the caller
    read them off ``captured`` when it captured the graph."""
    global launches
    launches += n


def _kernel():
    fn = build.load("paged_decode").paged_decode
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.restype = i32
        fn.argtypes = (
            [i32, i32] + [ptr] * 10 + [i32] * 11
            + [ctypes.c_float, ctypes.c_float, i32, ptr]
        )
    return fn


def _check(q, k_self, v_self, pages, layer, table, lens, scales):
    """Raise on anything the kernel does not accept."""
    dev = q.device
    named = dict(q=q, k_self=k_self, v_self=v_self, pages=pages,
                 table=table, lens=lens)
    if scales is not None:
        named["scales"] = scales
    for n, t in named.items():
        if t.device != dev:
            raise ValueError(f"paged decode: {n} on {t.device}, q on {dev}")
    if q.dim() != 3 or pages.dim() != 6:
        raise ValueError(
            f"paged decode: q {tuple(q.shape)} must be [B, Hq, D] and pages "
            f"{tuple(pages.shape)} [L, P, 2, Hkv, page, D]"
        )
    B, Hq, D = q.shape
    L, _, two, Hkv, _, Dp = pages.shape
    if two != 2 or Dp != D:
        raise ValueError(f"paged decode: pool shape {tuple(pages.shape)} "
                         f"does not match q {tuple(q.shape)}")
    for n, t in (("k_self", k_self), ("v_self", v_self)):
        if tuple(t.shape) != (B, Hkv, D):
            raise ValueError(f"paged decode: {n} {tuple(t.shape)} != "
                             f"{(B, Hkv, D)}")
        if t.dtype != q.dtype:
            raise ValueError(f"paged decode: {n} is {t.dtype}, q {q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged decode: q dtype {q.dtype} unsupported")
    if pages.dtype == torch.int8:
        if scales is None or scales.dtype != torch.float32 or (
            tuple(scales.shape) != tuple(pages.shape[:-1])
        ):
            raise ValueError("paged decode: an int8 pool needs f32 scales "
                             f"of shape {tuple(pages.shape[:-1])}")
    elif pages.dtype != q.dtype or scales is not None:
        raise ValueError(f"paged decode: pool {pages.dtype} with q "
                         f"{q.dtype} (scales only with an int8 pool)")
    if D % 8 or D > MAX_D:
        raise ValueError(f"paged decode: head dim {D} must be a multiple "
                         f"of 8 and <= {MAX_D}")
    if (D * pages.element_size()) % 16:
        raise ValueError(f"paged decode: a pool row of {D} x "
                         f"{pages.dtype} is not a whole number of 16-byte "
                         "chunks (int8 pools need D % 16 == 0)")
    if pages.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("paged decode: q and the pool must be 16-byte "
                         "aligned")
    if Hq % Hkv or Hq // Hkv > MAX_REP:
        raise ValueError(f"paged decode: {Hq} query heads over {Hkv} kv "
                         f"heads (need a multiple, at most {MAX_REP} each)")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError("paged decode: table and lens must be int32")
    if table.dim() != 2 or table.shape[0] != B or table.stride(1) != 1:
        raise ValueError(f"paged decode: table {tuple(table.shape)} must be "
                         f"[{B}, M] with unit column stride")
    if tuple(lens.shape) != (B,):
        raise ValueError(f"paged decode: lens {tuple(lens.shape)} != ({B},)")
    for n, t in named.items():
        if n != "table" and not t.is_contiguous():
            raise ValueError(f"paged decode: {n} must be contiguous")
    if not 0 <= layer < L:
        raise ValueError(f"paged decode: layer {layer} outside [0, {L})")


def decode(
    q: torch.Tensor,          # [B, Hq, D]
    k_self: torch.Tensor,     # [B, Hkv, D] current token's K (not in pool)
    v_self: torch.Tensor,     # [B, Hkv, D]
    pages: torch.Tensor,      # [L, P, 2, Hkv, page, D] the WHOLE pool
    layer: int,               # layer index
    table: torch.Tensor,      # [B, M] i32 (M may be a narrowed width)
    lens: torch.Tensor,       # [B] i32 tokens resident in the pool (excl. self)
    *,
    softmax_scale: Optional[float] = None,
    soft_cap: Optional[float] = None,
    sliding_window: Optional[int] = None,
    scales: Optional[torch.Tensor] = None,  # [L, P, 2, Hkv, page] f32
    pages_per_split: Optional[int] = None,  # see ``plan``
) -> torch.Tensor:
    """Attention of one new token per slot over its pages plus itself, on
    the card. Returns ``[B, Hq, D]`` in q's dtype."""
    layer = int(layer)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode: unsupported device {q.device}")
    _check(q, k_self, v_self, pages, layer, table, lens, scales)
    B, Hq, D = q.shape
    _, P, _, Hkv, page, _ = pages.shape
    if softmax_scale is None:
        softmax_scale = D ** -0.5
    width = table.shape[1]
    sp = plan(width, page, pages_per_split)
    out = torch.empty_like(q)
    # split partials: acc [B, Hkv, n_splits, n_rep, D], then (m, l)
    work = torch.empty(B * Hq * sp.n_splits * (D + 2), dtype=torch.float32,
                       device=q.device)
    arrivals = counters(q.device, B * Hkv)
    rc = _kernel()(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[pages.dtype],
        q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(),
        pages.data_ptr(), scales.data_ptr() if scales is not None else None,
        table.data_ptr(), lens.data_ptr(), out.data_ptr(), work.data_ptr(),
        arrivals.data_ptr(),
        layer, B, Hq, Hkv, D, P, page, width, table.stride(0),
        sp.pages_per_split, sp.n_splits,
        float(softmax_scale), float(soft_cap or 0.0),
        int(sliding_window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_decode kernel launch failed: CUDA error {rc}")
    _count_launch()
    return out
