"""The port stands alone: importing every ``areal_tpu_torch`` module (and
``chip_smoke.py``) loads neither ``jax`` nor ``areal_tpu`` (nor
``safetensors``, ``triton``, ``aiohttp`` or ``zmq``, which the card's
machine need not have); no source line imports them; the async code of
``system/`` and ``gen/`` passes the repo's async-hygiene scanner; entry
points refuse to fall back to the CPU; the kernel build raises when the
toolchain is missing.

The import check runs in a subprocess: this test process already imported
jax through ``tests/conftest.py``.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from areal_tpu_torch.gen import engine as pt_engine
from areal_tpu_torch.models import transformer as pt_tfm
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.ops.cuda import build
from areal_tpu_torch.train import engine as pt_train

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "areal_tpu_torch"
CFG = ModelConfig(n_layers=1, n_q_heads=2, n_kv_heads=1, head_dim=8,
                  hidden_dim=16, intermediate_dim=32, vocab_size=32,
                  dtype="float32")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import areal_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    areal_tpu_torch.__path__, "areal_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "areal_tpu",
                                    "safetensors", "triton", "aiohttp",
                                    "zmq"))
print(len(names), bad)
assert not bad, bad
for n in ("areal_tpu_torch.ops.fused_sample",
          "areal_tpu_torch.ops.cuda.fused_sample",
          "areal_tpu_torch.base.safetensors_io",
          "areal_tpu_torch.base.recover", "areal_tpu_torch.models.hf",
          "areal_tpu_torch.gen.client", "areal_tpu_torch.system.gserver_manager",
          "areal_tpu_torch.system.rollout_worker",
          "areal_tpu_torch.system.push_pull_stream",
          "areal_tpu_torch.agents.math_single_step",
          "areal_tpu_torch.base.seeding", "areal_tpu_torch.base.timeutil",
          "areal_tpu_torch.base.flops", "areal_tpu_torch.base.hbm",
          "areal_tpu_torch.base.metrics", "areal_tpu_torch.api.dfg",
          "areal_tpu_torch.experiments.graphs",
          "areal_tpu_torch.experiments.config",
          "areal_tpu_torch.system.function_executor",
          "areal_tpu_torch.system.worker_base",
          "areal_tpu_torch.system.trainer_worker",
          "areal_tpu_torch.apps.launcher", "areal_tpu_torch.apps.main",
          "areal_tpu_torch.train.generation",
          "areal_tpu_torch.system.sync_trainer",
          "areal_tpu_torch.interfaces.reward", "areal_tpu_torch.apps.profile",
          "areal_tpu_torch.datasets.prompt_answer",
          "areal_tpu_torch.datasets.rw_paired"):
    assert n in names, n
"""


def test_importing_the_port_loads_no_jax():
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20, r.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|areal_tpu|aiohttp|zmq)(?![\w])",
    re.MULTILINE,
)


def test_no_source_line_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 15
    offenders = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in files for m in _FORBIDDEN.finditer(p.read_text())
    ]
    assert not offenders, offenders


def test_async_code_passes_the_hygiene_scanner():
    """No bare ``asyncio.gather``, no discarded ``create_task``, no
    ``time.sleep`` in an ``async def`` and no ``shutil.rmtree`` outside
    ``base/recover.py`` in the port's system and generation layers."""
    from tools import check_async_hygiene

    paths = [str(PORT / "system"), str(PORT / "gen")]
    assert len(list((PORT / "system").glob("*.py"))) >= 8
    findings = check_async_hygiene.scan_paths(paths)
    assert not findings, [str(f) for f in findings]


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_tfm.init_params(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_tfm.params_from_numpy({"embed": {"weight": np.zeros((2, 2))}})
    params = pt_tfm.init_params(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_engine.GenerationEngine(CFG, params, max_slots=1, max_seqlen=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_train.TrainEngine(CFG)
    # an explicit CPU device is honoured
    eng = pt_engine.GenerationEngine(CFG, params, max_slots=1, max_seqlen=16,
                                     page_size=8, device="cpu")
    assert eng.state.cache.pages.device.type == "cpu"
    assert pt_train.TrainEngine(CFG, device="cpu").device.type == "cpu"


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path / "build"))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("paged_decode")
    with pytest.raises(RuntimeError, match="no CUDA source"):
        build.load("no_such_kernel")
    assert not (tmp_path / "build").exists()


_BUILD_RACE = r"""
import json, os, sys, time
from areal_tpu_torch.ops.cuda import build

lib = build.pathlib.Path(sys.argv[1])
log = sys.argv[2]
start = float(sys.argv[3])
while time.time() < start:
    time.sleep(0.001)

def compile_stub(tmps):
    with open(log, "a") as f:
        f.write(f"{os.getpid()}\n")
    for n, tmp in tmps.items():
        with open(tmp, "w") as f:
            f.write("half")
            f.flush()
            time.sleep(0.5)       # a reader must never see this
            f.write(" and whole")
    return {}

built = build.locked_build({"stub": lib}, compile_stub)
print(json.dumps({"built": built, "content": lib.read_text()}))
"""


def test_kernel_build_is_safe_across_processes(tmp_path):
    """Two processes reach the same library at once: the file lock makes
    one of them compile it, the other wait and find it built; the library
    appears whole (written under a temporary name, then renamed)."""
    import json
    import time

    lib = tmp_path / "build" / "libstub-0123.so"
    log = tmp_path / "compiles.log"
    start = str(time.time() + 2.0)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_RACE, str(lib), str(log), start],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    results = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert sorted(len(r["built"]) for r in results) == [0, 1]
    assert all(r["content"] == "half and whole" for r in results)
    assert len(log.read_text().split()) == 1
    assert sorted(p.name for p in lib.parent.iterdir()) == [
        lib.name, lib.name + ".lock"]


def test_locked_build_raises_and_keeps_what_built(tmp_path):
    paths = {n: tmp_path / f"lib{n}.so" for n in ("good", "bad")}

    def compile_half(tmps):
        tmps["good"].write_text("ok")
        return {"bad": "(exit 1): boom"}

    with pytest.raises(RuntimeError, match="nvcc failed for bad.cu"):
        build.locked_build(paths, compile_half)
    assert paths["good"].read_text() == "ok"
    assert not paths["bad"].exists()
    # a retry compiles only what is still missing
    def compile_rest(tmps):
        assert set(tmps) == {"bad"}
        tmps["bad"].write_text("fixed")
        return {}

    assert build.locked_build(paths, compile_rest) == ["bad"]
    assert paths["bad"].read_text() == "fixed"


def test_chip_smoke_builds_every_cuda_source():
    import chip_smoke

    sources = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert set(chip_smoke.SOURCES) == sources and len(sources) == 3


def test_every_cuda_source_is_named_by_a_wrapper():
    sources = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert sources == {"paged_decode", "flash_attention", "fused_sample"}
    for name, wrapper in (("paged_decode", "paged_attention.py"),
                          ("flash_attention", "flash_attention.py"),
                          ("fused_sample", "fused_sample.py")):
        text = (PORT / "ops" / "cuda" / wrapper).read_text()
        assert f'build.load("{name}")' in text
