"""Build the port's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), which is loaded
with ``ctypes``. Libraries land in a git-ignored build directory
(``areal_tpu_torch/build`` or ``$AREAL_TORCH_BUILD_DIR``), named by a hash
of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. Sources that need building are compiled
together, one ``nvcc`` process each.

Several processes may build at once (a launcher's gen server and trainer
both reach their kernels at first use): each library is built under an
exclusive file lock beside it, re-checked once the lock is held, written
under a temporary name and renamed into place, so no process loads a
half-written library and a source is compiled once.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

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


def locked_build(paths: Dict[str, pathlib.Path], compile_fn) -> List[str]:
    """Build the libraries of ``paths`` that no process has built yet.
    Takes an exclusive lock file beside each library (in sorted order, so
    two processes never deadlock), re-checks which are still missing, and
    calls ``compile_fn({name: temporary path})``, which writes each
    library it can to its temporary path and returns ``{name: error}``
    for the ones it cannot. The built ones are renamed into place before
    the locks are released; then a failure raises ``RuntimeError``.
    Returns the names built by this call."""
    locks = []
    try:
        for n in sorted(paths):
            paths[n].parent.mkdir(parents=True, exist_ok=True)
            f = open(paths[n].with_name(paths[n].name + ".lock"), "w")
            fcntl.flock(f, fcntl.LOCK_EX)
            locks.append(f)
        missing = [n for n in paths if not paths[n].exists()]
        if not missing:
            return []
        tmps = {n: paths[n].with_name(f"{paths[n].stem}.{os.getpid()}.tmp")
                for n in missing}
        failed = compile_fn(tmps)
        for n in missing:
            if n not in failed:
                os.replace(tmps[n], paths[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(
                f"{n}.cu {err}" for n, err in failed.items()))
        return missing
    finally:
        for f in locks:
            fcntl.flock(f, fcntl.LOCK_UN)
            f.close()


def _nvcc_compile(nvcc: str, tmps: Dict[str, pathlib.Path],
                  paths: Dict[str, pathlib.Path]) -> Dict[str, str]:
    """One nvcc process per source, all started together."""
    t0 = time.perf_counter()
    procs = {}
    for n, tmp in tmps.items():
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    failed = {}
    for n, proc in procs.items():
        out, _ = proc.communicate()
        build_log[n] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": out.strip(),
            "path": str(paths[n]),
        }
        if proc.returncode != 0:
            failed[n] = f"(exit {proc.returncode}):\n{out}"
    return failed


def load_all(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) whatever is not built yet, then load every
    library named. Raises ``RuntimeError`` with nvcc's output on failure."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        paths = {n: _library_path(n) for n in todo}
        missing = [n for n in todo if not paths[n].exists()]
        if missing:
            nvcc = nvcc_path()
            locked_build(
                {n: paths[n] for n in missing},
                lambda tmps: _nvcc_compile(nvcc, tmps, paths),
            )
        for n in todo:
            build_log.setdefault(
                n, {"seconds": 0.0, "ptxas": "", "path": str(paths[n])}
            )
            _libs[n] = ctypes.CDLL(str(paths[n]))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    return load_all([name])[name]
