"""A reader and writer of the safetensors file format on numpy and torch
alone (the ``safetensors`` package is not needed).

The format: an 8-byte little-endian header length ``N``, ``N`` bytes of
JSON mapping each tensor name to ``{"dtype", "shape", "data_offsets":
[begin, end]}`` (offsets into the byte buffer that follows the header, in
file order, without gaps) plus an optional ``"__metadata__"`` map of
strings, then the raw little-endian buffer. Files written here are byte
for byte what the ``safetensors`` package writes for the same tensors:
tensors ordered by descending dtype rank (wider types first, so every
tensor starts aligned) then name, a compact JSON header padded with spaces
to a multiple of 8 bytes.

Dtypes: F32, F16, BF16, I64, I32, I8, BOOL. numpy has no bfloat16, so the
reader returns ``torch.Tensor`` (BF16 passes through a 16-bit integer
view); the writer takes torch tensors or numpy arrays.
"""

import json
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I8": torch.int8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
# the package's dtype order, ascending; it lays tensors out descending
_RANK = {n: i for i, n in enumerate(
    ("BOOL", "I8", "F16", "BF16", "I32", "F32", "I64"))}
# torch dtypes numpy cannot view directly -> a same-width integer stand-in
_RAW_VIEW = {torch.bfloat16: torch.int16, torch.bool: torch.uint8}
_MAX_HEADER = 100_000_000


_NUMPY_NAMES = {
    np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64", np.dtype(np.int32): "I32",
    np.dtype(np.int8): "I8", np.dtype(np.bool_): "BOOL",
}


def _dtype_name(name: str, t) -> str:
    key = t.dtype.newbyteorder("=") if isinstance(t, np.ndarray) else t.dtype
    found = (_NUMPY_NAMES if isinstance(t, np.ndarray) else _NAMES).get(key)
    if found is None:
        raise ValueError(f"safetensors: unsupported dtype {t.dtype} for "
                         f"{name!r}")
    return found


def _raw_buffer(t) -> memoryview:
    """The tensor's elements as little-endian bytes in row-major order,
    whatever its strides: writing a strided view's buffer as it lies would
    silently store other data under its name. Copies only what is not
    contiguous already."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        t = t.view(_RAW_VIEW[t.dtype]) if t.dtype in _RAW_VIEW else t
        t = t.numpy()
    if t.dtype.byteorder == ">":
        t = t.byteswap()
    return np.ascontiguousarray(t).reshape(-1).view(np.uint8).data


def save_file(
    tensors: Mapping[str, Union[torch.Tensor, np.ndarray]],
    path: str,
    metadata: Optional[Dict[str, str]] = None,
) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) to ``path``."""
    names = {n: _dtype_name(n, t) for n, t in tensors.items()}
    order = sorted(tensors, key=lambda n: (-_RANK[names[n]], n))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name in order:
        t = tensors[name]
        item = torch.empty((), dtype=_DTYPES[names[name]]).element_size()
        n = int(np.prod(t.shape, dtype=np.int64)) * item
        header[name] = {"dtype": names[name], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":"),
                      ensure_ascii=False).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            f.write(_raw_buffer(tensors[name]))


def _read_header(f):
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError("safetensors: file shorter than its header length")
    (n,) = struct.unpack("<Q", raw)
    if n > _MAX_HEADER:
        raise ValueError(f"safetensors: header of {n} bytes is too large")
    blob = f.read(n)
    if len(blob) != n:
        raise ValueError("safetensors: truncated header")
    header = json.loads(blob.decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError("safetensors: header is not a JSON object")
    return header


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of ``path`` into host memory (one read of the
    buffer; the tensors are views of it)."""
    with open(path, "rb") as f:
        header = _read_header(f)
        buf = np.fromfile(f, dtype=np.uint8)
    out: Dict[str, torch.Tensor] = {}
    whole = torch.from_numpy(buf)
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dt = _DTYPES[info["dtype"]]
        except KeyError:
            raise ValueError(f"safetensors: unsupported dtype "
                             f"{info['dtype']!r} for {name!r}") from None
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        item = torch.empty((), dtype=dt).element_size()
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if not 0 <= begin <= end <= buf.size or end - begin != count * item:
            raise ValueError(f"safetensors: bad offsets {begin, end} for "
                             f"{name!r} of shape {shape} {info['dtype']}")
        chunk = whole[begin:end]
        if begin % item:
            chunk = chunk.clone()       # a view must be aligned to its type
        raw = _RAW_VIEW.get(dt, dt)
        t = chunk.view(raw).view(dt) if raw is not dt else chunk.view(dt)
        out[name] = t.reshape(shape)
    return out
