"""Fused LM-head + sampling epilogue: the hand-written CUDA kernel's wrapper.

``fused_sample`` is the port of ``areal_tpu/ops/pallas/fused_sample.py::
fused_sample_pallas`` (same operands, same result dict). It launches
``csrc/fused_sample.cu`` (the source says what bounds it and how it is laid
out) on the current stream for CUDA tensors and raises on anything else.
Its plain PyTorch version is ``ops/fused_sample.py::fused_sample_plain``;
``fused_sample`` there picks one of the two by the tensors' device. Nothing
falls back from the kernel to the plain version.

The head ``w [E, V]`` is read where it lies: with V contiguous (an untied
head) or with E contiguous (tied embeddings hand over ``embed.T``). It is
never copied; any other layout raises.

Two passes compute the head product (``choose_pass`` picks one from the
operands): ``v3`` (wgmma, TMA, one read of the head for every row) for the
serving layout, and the CUDA-core pass for everything else. Both end in the
same merge kernel over per-row partial records; ``plan`` mirrors v3's
schedule (row bands, blocks per band), which sizes those records.

``launches`` counts kernel launches the card ran (one per call: the
partial pass and its merge pass together), so a run can show that its main
path went through the kernel. A call under CUDA graph capture adds to
``captured`` instead; whoever replays the graph adds what its capture
recorded (``credit``). The workspaces are allocated per call, so under
capture they come from the graph's memory pool.
"""

import ctypes
from typing import Dict, Optional

import torch

from areal_tpu_torch.ops.cuda import build

SOURCE = "areal_tpu_torch/csrc/fused_sample.cu"
REPLACES = "areal_tpu/ops/pallas/fused_sample.py:162"
PARTIAL_FLOATS = 6   # floats per partial record (kPF)
PARTIAL_INTS = 2     # ints per partial record (kPI)
# v3's tiling (csrc/fused_sample.cu: kGroupRows, kTileN)
GROUP_ROWS = 64      # rows per block: wgmma's M
TILE_V3 = 256        # vocabulary columns per tile

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
captured = 0


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


def _library():
    lib = build.load("fused_sample")
    fn = lib.fused_sample
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.restype = i32
        fn.argtypes = (
            [i32, i32, i32, ptr, i64, ptr, i64] + [ptr] * 5
            + [ctypes.c_float, i32, i32, i32] + [ptr] * 7 + [ptr]
        )
        lib.fused_sample_slots.restype = i32
        lib.fused_sample_slots.argtypes = [i32, i32, i32]
        lib.fused_sample_plan.restype = i32
        lib.fused_sample_plan.argtypes = [i32, i32, ptr]
        lib.fused_sample_sms.restype = i32
        lib.fused_sample_sms.argtypes = []
    return lib


def plan(R: int, V: int, sms: int) -> Dict[str, int]:
    """v3's schedule for ``R`` rows over ``V`` columns, as the kernel's
    ``v3_plan`` computes it: one band per group of ``GROUP_ROWS`` rows,
    the card's ``sms`` (one block each) dealt to the bands, and no more
    blocks in a band than there are tiles. Each block's two consumer
    warpgroups write one partial record per row of its band: ``slots``
    per row, ``records`` in all."""
    bands = -(-R // GROUP_ROWS)
    tiles = -(-V // TILE_V3)
    per_band = max(1, min(sms // bands, tiles))
    return dict(bands=bands, tiles=tiles, per_band=per_band,
                blocks=bands * per_band, slots=2 * per_band,
                records=2 * per_band * R)


def v3_unsupported(dtype, v_contig: bool, E: int, V: int, x_ld: int,
                   w_ld: int, x_ptr: int, w_ptr: int) -> Optional[str]:
    """Why v3 cannot take these operands, or None. v3 reads x and W by
    TMA into wgmma's bf16 tiles with W MN-major: bf16, V contiguous, E, V
    and both row strides multiples of 8 elements (16 bytes), both bases
    16-byte aligned. Any number of rows (one band of blocks per 64)."""
    if dtype != torch.bfloat16:
        return f"dtype {dtype}: v3 runs bf16 operands"
    if not v_contig:
        return "E-contiguous head: v3 reads W with V contiguous"
    for name, val in (("E", E), ("V", V), ("x row stride", x_ld),
                      ("w row stride", w_ld)):
        if val % 8:
            return f"{name} {val} is not a multiple of 8"
    for name, ptr in (("x", x_ptr), ("w", w_ptr)):
        if ptr % 16:
            return f"{name} is not 16-byte aligned"
    return None


def choose_pass(dtype, v_contig: bool, E: int, V: int, x_ld: int,
                w_ld: int, x_ptr: int, w_ptr: int,
                cuda_cores: bool = False) -> str:
    """``"v3"`` where v3 takes the operands (``v3_unsupported``) and the
    caller did not ask for the CUDA cores, else ``"cuda_cores"``. The
    number of rows does not enter: v3 takes any."""
    if cuda_cores or v3_unsupported(dtype, v_contig, E, V, x_ld, w_ld,
                                    x_ptr, w_ptr):
        return "cuda_cores"
    return "v3"


def _check(seed, x, w, temperature, greedy, exclude, gather_ids) -> bool:
    """Raise on anything the kernel does not accept. Returns whether the
    head's columns (V) are the contiguous axis."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(
            f"fused sample: x {tuple(x.shape)} must be [R, E] and w "
            f"{tuple(w.shape)} [E, V]"
        )
    R, E = x.shape
    V = w.shape[1]
    if R < 1 or E < 1 or V < 1:
        raise ValueError(f"fused sample: empty operands R {R} E {E} V {V}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(
            f"fused sample: x is {x.dtype} and w {w.dtype}; both must be "
            "float32 or both bfloat16"
        )
    if x.stride(1) != 1:
        raise ValueError(f"fused sample: x strides {x.stride()} need a unit "
                         "stride over E")
    item = w.element_size()
    if w.stride(1) == 1 and w.stride(0) >= V:
        v_contig = True
    elif w.stride(0) == 1 and w.stride(1) >= E:
        v_contig = False
        if E % 4 or w.stride(1) % 4 or w.data_ptr() % (4 * item):
            raise ValueError(
                "fused sample: a head with E contiguous is read four "
                f"elements at a time; E {E}, column stride {w.stride(1)} "
                "and the data pointer must be multiples of 4 elements"
            )
    else:
        raise ValueError(
            f"fused sample: head strides {w.stride()} for shape "
            f"{tuple(w.shape)}: either V or E must be contiguous (the head "
            "is never copied)"
        )
    rows = dict(temperature=(temperature, torch.float32),
                greedy=(greedy, torch.bool))
    if exclude is not None:
        rows["exclude"] = (exclude, torch.int32)
    if gather_ids is not None:
        rows["gather_ids"] = (gather_ids, torch.int32)
    for n, (t, dt) in rows.items():
        if t.dtype != dt or tuple(t.shape) != (R,) or not t.is_contiguous():
            raise ValueError(
                f"fused sample: {n} must be a contiguous {dt} tensor of "
                f"shape ({R},), got {t.dtype} {tuple(t.shape)}"
            )
    if seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError("fused sample: seed must be one int32 element, got "
                         f"{seed.dtype} {tuple(seed.shape)}")
    named = dict(seed=seed, w=w, **{n: t for n, (t, _) in rows.items()})
    for n, t in named.items():
        if t.device != x.device:
            raise ValueError(f"fused sample: {n} on {t.device}, x on "
                             f"{x.device}")
    return v_contig


def fused_sample(
    seed: torch.Tensor,               # one int32 element, on the card
    x: torch.Tensor,                  # [R, E]
    w: torch.Tensor,                  # [E, V], V or E contiguous
    temperature: torch.Tensor,        # [R] f32
    greedy: torch.Tensor,             # [R] bool
    exclude: Optional[torch.Tensor] = None,      # [R] i32, -1 = none
    gather_ids: Optional[torch.Tensor] = None,   # [R] i32
    soft_cap: Optional[float] = None,
    cuda_cores: bool = False,
) -> Dict[str, torch.Tensor]:
    """One token per row from the streamed head, on the card. Returns
    ``tokens``, ``argmax`` (i32), ``logprobs``, ``norm`` (f32) and, with
    ``gather_ids``, ``gathered_lp`` (f32), each ``[R]``.

    The head product runs v3 on the tensor cores for the serving layout
    (``choose_pass``: bf16, V contiguous, E, V and the strides multiples
    of 8, 16-byte aligned) and on the CUDA cores otherwise;
    ``cuda_cores=True`` keeps it there (the card's check holds both
    versions against the plain one on one input)."""
    if x.device.type != "cuda":
        raise ValueError(f"fused sample: unsupported device {x.device}")
    v_contig = _check(seed, x, w, temperature, greedy, exclude, gather_ids)
    R, E = x.shape
    V = w.shape[1]
    w_ld = w.stride(0) if v_contig else w.stride(1)
    v3 = choose_pass(x.dtype, v_contig, E, V, x.stride(0), w_ld,
                     x.data_ptr(), w.data_ptr(), cuda_cores) == "v3"
    lib = _library()
    dev = x.device
    slots = lib.fused_sample_slots(int(v3), R, V)
    part_f = torch.empty(slots * R * PARTIAL_FLOATS, dtype=torch.float32,
                         device=dev)
    part_i = torch.empty(slots * R * PARTIAL_INTS, dtype=torch.int32,
                         device=dev)
    out_i = torch.empty(2, R, dtype=torch.int32, device=dev)
    out_f = torch.empty(3, R, dtype=torch.float32, device=dev)
    rc = lib.fused_sample(
        int(v3), _DTYPE_CODE[x.dtype], int(v_contig),
        x.data_ptr(), x.stride(0), w.data_ptr(), w_ld,
        temperature.data_ptr(), greedy.data_ptr(),
        exclude.data_ptr() if exclude is not None else None,
        gather_ids.data_ptr() if gather_ids is not None else None,
        seed.data_ptr(), float(soft_cap or 0.0), R, E, V,
        part_f.data_ptr(), part_i.data_ptr(),
        out_i[0].data_ptr(), out_f[0].data_ptr(), out_i[1].data_ptr(),
        out_f[1].data_ptr(), out_f[2].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_sample kernel launch failed: CUDA error {rc}")
    _count_launch()
    out = {"tokens": out_i[0], "logprobs": out_f[0], "argmax": out_i[1],
           "norm": out_f[2]}
    if gather_ids is not None:
        out["gathered_lp"] = out_f[1]
    return out
