"""Env-var knobs and experiment roots the port reads (a copy of the
port's subset of ``areal_tpu/base/constants.py``: the same names, the same
defaults and the same tolerant parsing). The default file root lies under
the process's temporary directory (``/tmp`` unless ``TMPDIR`` says
otherwise), as the reference's does.
"""

import getpass
import logging
import os
import tempfile
from typing import Optional

_logger = logging.getLogger("areal_tpu_torch.constants")

# KV-pool quantization (docs/performance.md "KV quantization").
KV_DTYPE_ENV = "AREAL_KV_DTYPE"         # paged KV pool storage dtype


# trainer survivability and memory pressure (worker_base.py, hbm.py)
MEMORY_KILL_ENV = "AREAL_HBM_KILL_THRESHOLD"
MEMORY_WARN_ENV = "AREAL_HBM_WARN_THRESHOLD"
PREEMPT_DEADLINE_ENV = "AREAL_PREEMPT_DEADLINE_S"  # SIGTERM -> ckpt-save budget
WATCHDOG_TIMEOUT_ENV = "AREAL_WATCHDOG_TIMEOUT_S"  # 0/unset disables the watchdog
WATCHDOG_ABORT_ENV = "AREAL_WATCHDOG_ABORT"   # dump AND exit so the scheduler restarts
TELEMETRY_EXPORT_ENV = "AREAL_TELEMETRY_EXPORT"
TRAIN_PREFETCH_ENV = "AREAL_TRAIN_PREFETCH"   # deferred stats (flush cadence)


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(name, default)


def kv_dtype() -> Optional[str]:
    """``AREAL_KV_DTYPE`` (default unset = serving dtype, i.e. raw bf16
    pages). ``"int8"`` stores quantized pages with per-(page-slot, kv-head)
    scales. Unknown values fall back to unset (logged), not crash. An
    explicit ``cfg.kv_dtype`` / engine argument overrides this knob."""
    raw = env_str(KV_DTYPE_ENV)
    if raw is None or not raw.strip():
        return None
    v = raw.strip().lower()
    if v == "int8":
        return "int8"
    if v in ("bf16", "bfloat16"):
        return "bf16"
    _logger.warning(
        "ignoring unknown %s=%r (using the serving dtype)", KV_DTYPE_ENV, raw
    )
    return None


# Fused sampling epilogue (docs/performance.md "Fused sampling epilogue").
FUSED_SAMPLE_ENV = "AREAL_FUSED_SAMPLE"  # streamed LM-head + sampling epilogue
_OFF_STRINGS = ("", "0", "false", "off", "no", "n")


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: unset -> ``default``; ""/"0"/"false"/"off"/"no"/"n" ->
    False; anything else -> True."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in _OFF_STRINGS


def fused_sample_enabled() -> bool:
    """``AREAL_FUSED_SAMPLE`` (default off): decode chunks sample through
    the fused LM-head + sampling epilogue (``ops/fused_sample.py``), so the
    full ``[B, V]`` logits tensor is never materialized for greedy,
    plain-temperature and top-k slots; top-p rows keep the sorted sampler
    through the warp-row bucket. Token-exact for greedy slots,
    distribution-exact for sampled slots. An explicit engine argument
    overrides this knob."""
    return env_flag(FUSED_SAMPLE_ENV, False)


# Decode-chunk pipelining (the reference's ``pipeline_chunks``).
DECODE_PIPELINE_ENV = "AREAL_DECODE_PIPELINE"


def decode_pipeline_enabled() -> bool:
    """``AREAL_DECODE_PIPELINE`` (default off): harvest decode chunks one
    late so the per-chunk host sync overlaps the next chunk's compute. An
    explicit ``pipeline_chunks`` engine argument overrides this knob."""
    return env_flag(DECODE_PIPELINE_ENV, False)


def env_float(name: str, default: float) -> float:
    """Tolerant float knob: malformed values fall back to the default
    (logged) instead of crashing a worker at startup."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return float(raw)
    except ValueError:
        _logger.warning(
            "ignoring malformed %s=%r (using %s)", name, raw, default
        )
        return default


def env_knob(name: str, default_depth: int) -> int:
    """Pipeline-depth knob: unset/"true"/"on" -> the default depth,
    "false"/"off" -> 0 (disabled), an integer -> exactly that depth."""
    v = os.environ.get(name)
    if v is None or v.strip().lower() in ("", "true", "on"):
        return default_depth
    if v.strip().lower() in ("false", "off"):
        return 0
    try:
        return max(int(v), 0)
    except ValueError:
        return default_depth


def train_prefetch_enabled() -> bool:
    """``AREAL_TRAIN_PREFETCH`` (default on): the trainer worker logs its
    stats once per ``stats_log_freq_steps`` steps instead of every step
    (the reference's deferred-stats cadence)."""
    return env_knob(TRAIN_PREFETCH_ENV, 1) > 0


# --------------------------------------------------------------------- #
# memory pressure (base/hbm.py)
# --------------------------------------------------------------------- #


def hbm_warn_threshold() -> float:
    """``AREAL_HBM_WARN_THRESHOLD`` (default 0.92): fraction of the
    device's memory past which the memory monitor logs a warning."""
    return env_float(MEMORY_WARN_ENV, 0.92)


def hbm_kill_threshold() -> float:
    """``AREAL_HBM_KILL_THRESHOLD`` (default 1.0 = disabled): fraction of
    the device's memory past which the worker raises HBMPressureError."""
    return env_float(MEMORY_KILL_ENV, 1.0)


def hbm_check_secs() -> float:
    """``AREAL_HBM_CHECK_SECS`` (default 30.0): wall-clock period of the
    gen server's memory kill check."""
    return env_float("AREAL_HBM_CHECK_SECS", 30.0)


# --------------------------------------------------------------------- #
# rendezvous, telemetry, survivability
# --------------------------------------------------------------------- #


def default_root() -> str:
    """``areal_tpu`` in the process's temporary directory (``$TMPDIR``,
    else ``/tmp``): where the file root and the name-resolve root lie
    unless set."""
    return os.path.join(tempfile.gettempdir(), "areal_tpu")


def name_resolve_root() -> str:
    """``AREAL_NAME_RESOLVE_ROOT``: shared-FS root of the file-backed
    name-resolve repository."""
    return env_str(
        "AREAL_NAME_RESOLVE_ROOT", os.path.join(default_root(), "name_resolve")
    )


DEFAULT_TELEMETRY_INTERVAL_S = 15.0


def telemetry_export_interval() -> float:
    """``AREAL_TELEMETRY_EXPORT`` (default off): per-worker telemetry
    snapshot period in seconds; "true"/"on"/"1" -> 15 s. The exporter
    itself waits for the telemetry twin; the knob is read so configs
    carry over."""
    raw = env_str(TELEMETRY_EXPORT_ENV)
    if raw is None or raw.strip().lower() in _OFF_STRINGS:
        return 0.0
    if raw.strip().lower() in ("true", "on", "1"):
        return DEFAULT_TELEMETRY_INTERVAL_S
    return max(env_float(TELEMETRY_EXPORT_ENV, DEFAULT_TELEMETRY_INTERVAL_S),
               0.0)


def watchdog_abort_enabled() -> bool:
    """``AREAL_WATCHDOG_ABORT``: a stale heartbeat dumps stacks AND exits
    the worker with the watchdog code."""
    return env_flag(WATCHDOG_ABORT_ENV, False)


# --------------------------------------------------------------------- #
# experiment and trial names, roots
# --------------------------------------------------------------------- #

_experiment_name: Optional[str] = None
_trial_name: Optional[str] = None


def set_experiment_trial_names(experiment_name: str, trial_name: str):
    global _experiment_name, _trial_name
    _experiment_name = experiment_name
    _trial_name = trial_name


def experiment_name() -> str:
    if _experiment_name is None:
        raise RuntimeError("experiment name not set")
    return _experiment_name


def trial_name() -> str:
    if _trial_name is None:
        raise RuntimeError("trial name not set")
    return _trial_name


def get_fileroot() -> str:
    return os.environ.get(
        "AREAL_FILEROOT", os.path.join(default_root(), getpass.getuser())
    )


def set_fileroot(path: str):
    os.environ["AREAL_FILEROOT"] = path


def get_log_root() -> str:
    p = os.path.join(get_fileroot(), "logs", experiment_name(), trial_name())
    os.makedirs(p, exist_ok=True)
    return p


def get_save_root() -> str:
    p = os.path.join(get_fileroot(), "checkpoints", experiment_name(),
                     trial_name())
    os.makedirs(p, exist_ok=True)
    return p


def get_param_sync_root() -> str:
    """Directory for trainer -> generation weight-sync snapshots."""
    p = os.path.join(get_save_root(), "weight_sync")
    os.makedirs(p, exist_ok=True)
    return p


def get_recover_root() -> str:
    p = os.path.join(get_save_root(), "recover")
    os.makedirs(p, exist_ok=True)
    return p
