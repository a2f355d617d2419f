"""Build the port's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which is loaded
with ``ctypes``. Libraries land in a git-ignored build directory
(``areal_tpu_torch/build`` or ``$AREAL_TORCH_BUILD_DIR``), named by a hash
of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. Sources that need building are compiled
together, one ``nvcc`` process each.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR_ENV = "AREAL_TORCH_BUILD_DIR"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # per-kernel registers / shared memory / spills, kept in build_log
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": nvcc wall time (0.0 when loaded from the build dir),
#          "ptxas": the compiler's resource report, "path": library}
build_log: Dict[str, dict] = {}


def build_dir() -> pathlib.Path:
    return pathlib.Path(
        os.environ.get(BUILD_DIR_ENV) or PACKAGE_ROOT / "build"
    )


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def _library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise RuntimeError(f"no CUDA source {src}")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) whatever is not built yet, then load every
    library named. Raises ``RuntimeError`` with nvcc's output on failure."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        paths = {n: _library_path(n) for n in todo}
        missing = [n for n in todo if not paths[n].exists()]
        if missing:
            nvcc = nvcc_path()
            build_dir().mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            procs = {}
            for n in missing:
                tmp = paths[n].with_name(f"{paths[n].stem}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
                procs[n] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ))
            failed = []
            for n, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                build_log[n] = {
                    "seconds": time.perf_counter() - t0,
                    "ptxas": out.strip(),
                    "path": str(paths[n]),
                }
                if proc.returncode != 0:
                    failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
                else:
                    os.replace(tmp, paths[n])
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for n in todo:
            build_log.setdefault(
                n, {"seconds": 0.0, "ptxas": "", "path": str(paths[n])}
            )
            _libs[n] = ctypes.CDLL(str(paths[n]))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    return load_all([name])[name]
