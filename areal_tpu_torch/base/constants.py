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
# observability (base/tracing.py, system/worker_base.py FlightRecorder)
TRACE_ENV = "AREAL_DUMP_TRACE"                # torch.profiler traces per step
TRACE_SPANS_ENV = "AREAL_TRACE_SPANS"        # span ring + trace-id propagation
TRACE_RING_ENV = "AREAL_TRACE_RING"          # completed-span ring capacity
TRACE_FLUSH_ENV = "AREAL_TRACE_FLUSH_S"      # dedicated span-flush period
TRACE_LOG_TAIL_ENV = "AREAL_TRACE_LOG_TAIL"  # flight-recorder log-tail lines
NAME_RESOLVE_RPC_ENV = "AREAL_NAME_RESOLVE_RPC"  # host:port of the TCP store
TRAIN_PREFETCH_ENV = "AREAL_TRAIN_PREFETCH"   # deferred stats (flush cadence)


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(name, default)


def log_level() -> str:
    """``AREAL_LOG_LEVEL``: root log level of the port's loggers."""
    return (env_str("AREAL_LOG_LEVEL", "INFO") or "INFO").upper()


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


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        return int(raw)
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


# Speculative decoding (the reference's "Speculative decoding" knobs).
SPEC_DECODE_ENV = "AREAL_SPEC_DECODE"   # draft-and-verify decode chunks
SPEC_K_ENV = "AREAL_SPEC_K"             # draft tokens per slot per spec step
SPEC_DRAFT_MODEL_ENV = "AREAL_SPEC_DRAFT_MODEL"      # HF dir of draft model
SPEC_DRAFT_KV_DTYPE_ENV = "AREAL_SPEC_DRAFT_KV_DTYPE"  # draft KV pool dtype
SPEC_K_ADAPT_ENV = "AREAL_SPEC_K_ADAPT"  # retune spec_k from live accept stats


def spec_decode_enabled() -> bool:
    """``AREAL_SPEC_DECODE`` (default off): generation engines decode with
    speculative draft-and-verify chunks (self-drafting n-gram baseline;
    exactly distribution-preserving, so PPO-safe). An explicit
    ``spec_decode`` engine argument overrides this knob."""
    return env_flag(SPEC_DECODE_ENV, False)


def spec_k() -> int:
    """``AREAL_SPEC_K`` (default 4): draft tokens proposed per slot per
    speculative step; the verify pass scores K+1 positions in one forward.
    Floored at 1 (K=0 would be vanilla decode with extra steps)."""
    return max(1, env_int(SPEC_K_ENV, 4))


def spec_draft_model() -> Optional[str]:
    """``AREAL_SPEC_DRAFT_MODEL`` (default unset): HF checkpoint dir of a
    small draft MODEL for speculative decoding. Engines built without an
    explicit drafter AND with spec decode on load a ``TransformerDrafter``
    from it instead of the n-gram self-drafter; spec-disabled engines log
    and ignore it (a draft model costs pool memory and a per-step sweep).
    The draft's vocab must match the serving model's. Empty/unset ->
    None."""
    raw = env_str(SPEC_DRAFT_MODEL_ENV)
    if raw is None or not raw.strip():
        return None
    return raw.strip()


def spec_draft_kv_dtype() -> Optional[str]:
    """``AREAL_SPEC_DRAFT_KV_DTYPE`` (default unset = the draft's serving
    dtype): storage dtype of the draft model's paged KV pool, with the
    contract of ``AREAL_KV_DTYPE`` (``"int8"`` quantizes; unknown values
    fall back to unset, logged)."""
    raw = env_str(SPEC_DRAFT_KV_DTYPE_ENV)
    if raw is None or not raw.strip():
        return None
    v = raw.strip().lower()
    if v == "int8":
        return "int8"
    if v in ("bf16", "bfloat16"):
        return "bf16"
    _logger.warning(
        "ignoring unknown %s=%r (using the draft serving dtype)",
        SPEC_DRAFT_KV_DTYPE_ENV, raw,
    )
    return None


def spec_k_adapt_enabled() -> bool:
    """``AREAL_SPEC_K_ADAPT`` (default off): speculative engines retune
    ``spec_k`` between chunks from the live accept-length window (mean
    accept length with hysteresis, over a small fixed choice set, so the
    spec programs stay bounded)."""
    return env_flag(SPEC_K_ADAPT_ENV, False)


def train_prefetch_enabled() -> bool:
    """``AREAL_TRAIN_PREFETCH`` (default on): the trainer worker logs its
    stats once per ``stats_log_freq_steps`` steps instead of every step
    (the reference's deferred-stats cadence)."""
    return env_knob(TRAIN_PREFETCH_ENV, 1) > 0


# --------------------------------------------------------------------- #
# the serving gateway (gateway/): the reference's knobs, same defaults
# --------------------------------------------------------------------- #

GATEWAY_PORT_ENV = "AREAL_GATEWAY_PORT"          # 0 = pick a free port
GATEWAY_RATE_TPS_ENV = "AREAL_GW_RATE_TPS"       # per-tenant token bucket
GATEWAY_BURST_ENV = "AREAL_GW_BURST"             # token-bucket burst size
GATEWAY_MAX_QUEUE_ENV = "AREAL_GW_MAX_QUEUE"     # gateway queue cap
GATEWAY_ADMIT_OCC_ENV = "AREAL_GW_ADMIT_OCCUPANCY"  # KV-pool admit gate
GATEWAY_HEDGE_ENV = "AREAL_GW_HEDGE"             # hedged dispatch on/off
GATEWAY_DEADLINE_S_ENV = "AREAL_GW_DEADLINE_S"   # default request deadline


def gateway_port() -> int:
    """``AREAL_GATEWAY_PORT`` (default 0 = pick a free port): TCP port the
    OpenAI-compatible serving gateway binds."""
    return env_int(GATEWAY_PORT_ENV, 0)


def gateway_rate_tps() -> float:
    """``AREAL_GW_RATE_TPS`` (default 0 = unlimited): default per-tenant
    token-bucket refill rate in tokens/second (prompt + budgeted new
    tokens are charged at admission; unused budget is refunded at
    completion). Per-tenant overrides come from the gateway config."""
    return env_float(GATEWAY_RATE_TPS_ENV, 0.0)


def gateway_burst() -> float:
    """``AREAL_GW_BURST`` (default 0 = 4x the refill rate, itself 0 =
    unlimited): default per-tenant token-bucket burst capacity."""
    return env_float(GATEWAY_BURST_ENV, 0.0)


def gateway_max_queue() -> int:
    """``AREAL_GW_MAX_QUEUE`` (default 256): gateway-wide cap on queued
    (not yet dispatched) requests; past it new requests get 429."""
    return env_int(GATEWAY_MAX_QUEUE_ENV, 256)


def gateway_admit_occupancy() -> float:
    """``AREAL_GW_ADMIT_OCCUPANCY`` (default 0.95): KV-pool occupancy
    fraction past which the gateway stops dispatching to a server (the
    request waits in the fair queue instead of deep-queuing behind a
    full pool)."""
    return env_float(GATEWAY_ADMIT_OCC_ENV, 0.95)


def gateway_hedge() -> bool:
    """``AREAL_GW_HEDGE`` (default on): hedge a still-unstarted request to
    a second healthy backend once its time-to-first-token exceeds the live
    ``gw/ttft_s`` p95. The loser is cancelled; hedge volume is capped per
    tenant."""
    return env_flag(GATEWAY_HEDGE_ENV, True)


def gateway_deadline_s() -> float:
    """``AREAL_GW_DEADLINE_S`` (default 0 = none): default per-request
    deadline in seconds for tenants without an explicit
    ``default_deadline_s`` in their spec. Clients override per request via
    the ``timeout`` body field or ``X-Request-Deadline`` header."""
    return env_float(GATEWAY_DEADLINE_S_ENV, 0.0)


# --------------------------------------------------------------------- #
# the remote reward sandbox (rewards/remote.py)
# --------------------------------------------------------------------- #


def function_call_enabled() -> bool:
    """``AREAL_ENABLE_FUNCTION_CALL``: route math/code verification to the
    remote sandboxed function-call service."""
    return env_flag("AREAL_ENABLE_FUNCTION_CALL", False)


def functioncall_service_domain() -> str:
    """``AREAL_FUNCTIONCALL_SERVICE_DOMAIN``: base URL of the remote
    verification service ("" = unset)."""
    return env_str("AREAL_FUNCTIONCALL_SERVICE_DOMAIN", "") or ""


def functioncall_concurrency_override() -> Optional[int]:
    """``AREAL_FUNCTIONCALL_CONCURRENCY``: explicit per-process request
    cap; None -> derive from the shared budget / DP split."""
    raw = env_str("AREAL_FUNCTIONCALL_CONCURRENCY")
    if raw is None or raw.strip() == "":
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def functioncall_dp() -> int:
    """``AREAL_FUNCTIONCALL_DP`` (default 16): data-parallel caller count
    the shared sandbox budget is split across."""
    return env_int("AREAL_FUNCTIONCALL_DP", 16)


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


def name_resolve_rpc() -> Optional[str]:
    """``AREAL_NAME_RESOLVE_RPC``: ``host:port`` of the TCP name-resolve
    server (``base/name_resolve_server.py``; several hosts without a
    shared filesystem); None -> the file backend."""
    return env_str(NAME_RESOLVE_RPC_ENV)


def trace_enabled() -> bool:
    """``AREAL_DUMP_TRACE``: collect ``torch.profiler`` traces of the
    wrapped steps (``tracing.maybe_trace``) and name regions in them
    (``tracing.annotate``)."""
    return env_flag(TRACE_ENV, False)


def trace_step() -> int:
    """``AREAL_TRACE_STEP`` (default 3): which training step the trainers
    trace (tracing every step would grow without bound)."""
    return env_int("AREAL_TRACE_STEP", 3)


DEFAULT_TELEMETRY_INTERVAL_S = 15.0


def telemetry_export_interval() -> float:
    """``AREAL_TELEMETRY_EXPORT`` (default off): per-worker telemetry
    snapshot period in seconds (``worker_base.TelemetryExporter``).
    Unset/"0"/"false"/"off" disables the exporter entirely (no thread, no
    snapshot); "true"/"on"/"1" enables it at the default 15 s; another
    number sets the period."""
    raw = env_str(TELEMETRY_EXPORT_ENV)
    if raw is None or raw.strip().lower() in _OFF_STRINGS:
        return 0.0
    if raw.strip().lower() in ("true", "on", "1"):
        # "1" means "enabled", not a one-second firehose
        return DEFAULT_TELEMETRY_INTERVAL_S
    return max(env_float(TELEMETRY_EXPORT_ENV, DEFAULT_TELEMETRY_INTERVAL_S),
               0.0)


DEFAULT_TRACE_RING = 4096


def trace_spans_enabled() -> bool:
    """``AREAL_TRACE_SPANS`` (default on): stamp every ``tracing.span``
    with W3C-style trace / span ids, record its completion into the
    bounded per-process ring and carry the trace context over the HTTP
    hops. "0"/"off" reverts spans to bare counter accumulation."""
    return env_flag(TRACE_SPANS_ENV, True)


def trace_ring_size() -> int:
    """``AREAL_TRACE_RING`` (default 4096): capacity of the per-process
    completed-span ring; the oldest spans are overwritten (counted in
    ``trace/dropped``). Floored at 16, so a typed "0" cannot silently
    turn the flight recorder's span evidence off."""
    return max(16, env_int(TRACE_RING_ENV, DEFAULT_TRACE_RING))


def trace_flush_interval() -> float:
    """``AREAL_TRACE_FLUSH_S`` (default 0 = ride the telemetry exporter):
    period of a dedicated thread draining the completed-span ring to
    ``<fileroot>/trace_spans/<worker>.jsonl``. At 0 there is no such
    thread: the ring is flushed on every telemetry publish and once when
    the worker stops."""
    return max(0.0, env_float(TRACE_FLUSH_ENV, 0.0))


def trace_log_tail() -> int:
    """``AREAL_TRACE_LOG_TAIL`` (default 200): recent log lines the flight
    recorder keeps in memory for its dump (0 keeps none)."""
    return max(0, env_int(TRACE_LOG_TAIL_ENV, 200))


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


def trace_root() -> str:
    """``AREAL_FILEROOT`` for profiler traces (``traces/<tag>``), else the
    shared default root (not the per-user file root), as the reference
    keeps it."""
    return env_str("AREAL_FILEROOT", default_root())


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


def get_trace_span_root() -> str:
    """Where the per-worker span flushes land (one jsonl per worker;
    ``system/tracejoin.py`` merges them). Keyed by the file root only: the
    records carry their own worker identity."""
    p = os.path.join(get_fileroot(), "trace_spans")
    os.makedirs(p, exist_ok=True)
    return p


def get_flight_root() -> str:
    """Where flight-recorder dumps land (one JSON per dump)."""
    p = os.path.join(get_fileroot(), "flight")
    os.makedirs(p, exist_ok=True)
    return p
