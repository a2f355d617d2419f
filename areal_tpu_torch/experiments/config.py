"""Experiment config dataclasses (a copy of
``areal_tpu/experiments/config.py``): the async-PPO experiment (one
trainer, a generation fleet, rollout workers and the gserver manager) and
the in-process ones (sync PPO, SFT, paired reward-model training), loaded
from YAML with dotted-path overrides (``a.b.c=v``). The launcher compiles
them into worker processes.

``EvaluatorSpec`` is accepted so configs carry over; the launcher raises
``NotImplementedError`` when it is enabled (its worker is not ported
yet). ``GatewaySpec.enabled`` spawns the serving gateway. ``SFTExperiment`` and ``RWExperiment`` carry
one field the reference's do not: ``trainer_device``, as the PPO
experiments have it (``""`` = the card, ``"cpu"``).
"""

import dataclasses
import json
from typing import Any, Dict, List, Optional

from areal_tpu_torch.api.data import MicroBatchSpec
from areal_tpu_torch.api.model import GenerationHyperparameters, PPOHyperparameters
from areal_tpu_torch.models.config import ModelConfig
from areal_tpu_torch.parallel.mesh import ParallelConfig
from areal_tpu_torch.train.engine import OptimizerConfig


@dataclasses.dataclass
class ModelSpec:
    """One model role (actor / critic / ref): where the weights come from
    and how the model is laid out (the port trains on one device:
    ``parallel`` stays ``d1m1``)."""

    path: Optional[str] = None           # HF checkpoint dir
    arch: Optional[Dict[str, Any]] = None  # ModelConfig kwargs (random init)
    # ModelConfig knobs applied on top of either source, e.g.
    # remat_policy, loss_chunk_size, attn_max_seqlen, dtype
    overrides: Optional[Dict[str, Any]] = None
    parallel: str = "d1m1"               # ParallelConfig.from_str format
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    init_critic_from_actor: bool = False
    # master-weight dtype; "bfloat16" halves param + grad memory at some
    # optimizer-precision cost
    param_dtype: str = "float32"

    def model_config(self, is_critic: bool = False) -> ModelConfig:
        if self.path is not None:
            import os

            from areal_tpu_torch.models import hf as hf_conv

            with open(os.path.join(self.path, "config.json")) as f:
                hf_cfg = json.load(f)
            fam = hf_conv.family_for_model_type(hf_cfg["model_type"])
            cfg = fam.config_from_hf(hf_cfg)
            cfg = dataclasses.replace(cfg, is_critic=is_critic)
        else:
            assert self.arch is not None, "ModelSpec needs path or arch"
            cfg = ModelConfig(**{**self.arch, "is_critic": is_critic})
        if self.overrides:
            cfg = dataclasses.replace(cfg, **self.overrides)
        return cfg

    def parallel_config(self) -> ParallelConfig:
        return ParallelConfig.from_str(self.parallel)


@dataclasses.dataclass
class DatasetSpec:
    name: str = "math_code_prompt"   # registry name
    path: str = ""
    max_length: Optional[int] = None
    seed: int = 1


@dataclasses.dataclass
class GenFleetSpec:
    n_servers: int = 1
    max_slots: int = 8
    max_seqlen: int = 4096
    max_new_tokens_cap: int = 2048
    decode_steps_per_chunk: int = 16
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    device: str = ""                 # "" = the card; "cpu" forces CPU servers
    # tensor parallelism per server; the port serves on one device
    # (gen_server_main raises for tp_size > 1)
    tp_size: int = 1
    page_size: int = 128
    n_pages: Optional[int] = None    # KV pool size; None = max_slots * tables
    # speculative decoding: None defers to AREAL_SPEC_DECODE / AREAL_SPEC_K;
    # a draft model (HF dir) is loaded only when spec decode is on
    spec_decode: Optional[bool] = None
    spec_k: Optional[int] = None
    spec_draft_model: Optional[str] = None
    spec_draft_kv_dtype: Optional[str] = None
    # KV-pool storage dtype: None defers to cfg.kv_dtype / the
    # AREAL_KV_DTYPE env knob; "int8" stores quantized pages with
    # per-(page-slot, kv-head) scales
    kv_dtype: Optional[str] = None


@dataclasses.dataclass
class GatewaySpec:
    """The OpenAI-compatible serving gateway over the fleet
    (``apps/launcher.py::gateway_main``, ``gateway/``)."""

    enabled: bool = False
    # 0 -> AREAL_GATEWAY_PORT (itself 0 -> a free port)
    port: int = 0
    default_tenant: str = "anonymous"
    require_api_key: bool = False
    api_keys: Dict[str, str] = dataclasses.field(default_factory=dict)
    # per-tenant WFQ weights (unlisted tenants weigh 1.0)
    tenant_weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    # 0 -> AREAL_GW_RATE_TPS / AREAL_GW_BURST env defaults
    rate_tokens_per_s: float = 0.0
    burst_tokens: float = 0.0
    # <0 -> AREAL_GW_MAX_QUEUE / AREAL_GW_ADMIT_OCCUPANCY env defaults
    max_queue: int = -1
    admit_occupancy: float = -1.0
    # autoscaler: resizes the ROUTED subset of the spawned gen servers
    # from the fleet/ telemetry aggregate (gateway/autoscaler.py)
    autoscale: bool = False
    min_servers: int = 1
    autoscale_interval_s: float = 10.0
    autoscale_cooldown_s: float = 30.0
    # survivability plane (docs/serving.md "Survivability"):
    # per-request deadline default for tenants without their own (0 = none)
    default_deadline_s: float = 0.0
    # hedged dispatch; None defers to the AREAL_GW_HEDGE env knob
    hedge: Optional[bool] = None
    # brownout ladder (gateway/brownout.py): graceful degradation under
    # sustained saturation instead of uniform timeouts
    brownout: bool = False
    brownout_interval_s: float = 5.0
    brownout_min_hold_s: float = 30.0
    brownout_clamp_max_tokens: int = 256
    brownout_weight_floor: float = 1.0


@dataclasses.dataclass
class RolloutSpec:
    n_workers: int = 1
    max_concurrent_tasks: int = 16
    new_tokens_per_chunk: int = 256
    agent: str = "math-single-step"
    agent_args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    env: str = "math-code-single-step"
    env_args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ManagerSpec:
    max_head_offpolicyness: int = 4
    max_concurrent_rollouts: int = 128
    schedule_policy: str = "round_robin"


@dataclasses.dataclass
class TrainerControlSpec:
    total_train_steps: int = 100
    save_freq_steps: Optional[int] = None
    ckpt_freq_steps: Optional[int] = 50
    ckpt_freq_secs: Optional[float] = 600.0
    weight_sync_freq_steps: int = 1


@dataclasses.dataclass
class EvaluatorSpec:
    """The reference's checkpoint-watching evaluator. Accepted so configs
    carry over; ``enabled=True`` raises in the launcher until it is
    ported."""

    enabled: bool = False
    dataset: Optional[DatasetSpec] = None   # defaults to the train dataset
    max_prompts: Optional[int] = 64
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=lambda: GenerationHyperparameters(
            n=1, greedy=True, max_new_tokens=1024
        )
    )
    poll_interval: float = 30.0
    device: str = "cpu"


@dataclasses.dataclass
class AsyncPPOExperiment:
    """The fully asynchronous PPO experiment: a generation fleet, the
    gserver manager, rollout workers and one trainer."""

    experiment_name: str = "async-ppo"
    trial_name: str = "trial0"
    fileroot: str = ""
    seed: int = 1
    actor: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    critic: Optional[ModelSpec] = None
    reward: Optional[ModelSpec] = None   # trained RM scores rollouts when set
    use_ref_model: bool = True
    hf_family: str = "qwen2"
    dataset: DatasetSpec = dataclasses.field(default_factory=DatasetSpec)
    gen: GenFleetSpec = dataclasses.field(default_factory=GenFleetSpec)
    gateway: GatewaySpec = dataclasses.field(default_factory=GatewaySpec)
    rollout: RolloutSpec = dataclasses.field(default_factory=RolloutSpec)
    manager: ManagerSpec = dataclasses.field(default_factory=ManagerSpec)
    ppo: PPOHyperparameters = dataclasses.field(default_factory=PPOHyperparameters)
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    control: TrainerControlSpec = dataclasses.field(
        default_factory=TrainerControlSpec
    )
    train_batch_size: int = 32
    max_tokens_per_mb: int = 16384
    recover_mode: str = "disabled"    # disabled | auto | resume
    recover_retries: int = 1
    trainer_device: str = ""              # "" = the card; "cpu"
    ema_ref_eta: Optional[float] = None   # EMA reference-model update weight
    tokenizer_path: Optional[str] = None  # for the evaluator's answer decode
    evaluator: EvaluatorSpec = dataclasses.field(default_factory=EvaluatorSpec)

    @property
    def mb_spec(self) -> MicroBatchSpec:
        return MicroBatchSpec(max_tokens_per_mb=self.max_tokens_per_mb)


@dataclasses.dataclass
class SyncPPOExperiment:
    """Sync PPO: generate on the trainer's own weights, then update (zero
    off-policyness); the staleness-ablation control for async
    experiments."""

    experiment_name: str = "sync-ppo"
    trial_name: str = "trial0"
    fileroot: str = ""
    seed: int = 1
    actor: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    critic: Optional[ModelSpec] = None
    use_ref_model: bool = True
    ema_ref_eta: Optional[float] = None
    hf_family: str = "qwen2"
    tokenizer_path: Optional[str] = None
    dataset: DatasetSpec = dataclasses.field(default_factory=DatasetSpec)
    ppo: PPOHyperparameters = dataclasses.field(
        default_factory=lambda: PPOHyperparameters(
            use_decoupled_loss=False, recompute_logprob=False
        )
    )
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    control: TrainerControlSpec = dataclasses.field(
        default_factory=TrainerControlSpec
    )
    batch_size: int = 32              # prompts per step
    max_tokens_per_mb: int = 16384
    trainer_device: str = ""
    evaluator: EvaluatorSpec = dataclasses.field(default_factory=EvaluatorSpec)

    @property
    def mb_spec(self) -> MicroBatchSpec:
        return MicroBatchSpec(max_tokens_per_mb=self.max_tokens_per_mb)


@dataclasses.dataclass
class RWExperiment:
    """Paired reward-model training (the reference's rw experiment over
    ``rw_paired``): a critic-architecture model and the Bradley-Terry
    loss."""

    experiment_name: str = "rw"
    trial_name: str = "trial0"
    fileroot: str = ""
    seed: int = 1
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    hf_family: str = "qwen2"
    dataset: DatasetSpec = dataclasses.field(
        default_factory=lambda: DatasetSpec(name="rw_paired")
    )
    eval_dataset: Optional[DatasetSpec] = None
    control: TrainerControlSpec = dataclasses.field(
        default_factory=TrainerControlSpec
    )
    batch_size: int = 32
    max_tokens_per_mb: int = 16384
    max_pairs_per_prompt: int = 2
    tokenizer_path: Optional[str] = None
    trainer_device: str = ""              # "" = the card; "cpu"


@dataclasses.dataclass
class SFTExperiment:
    """Supervised fine-tuning (the reference's ``SFTConfig``)."""

    experiment_name: str = "sft"
    trial_name: str = "trial0"
    fileroot: str = ""
    seed: int = 1
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    hf_family: str = "qwen2"
    dataset: DatasetSpec = dataclasses.field(
        default_factory=lambda: DatasetSpec(name="prompt_answer")
    )
    eval_dataset: Optional[DatasetSpec] = None
    control: TrainerControlSpec = dataclasses.field(
        default_factory=TrainerControlSpec
    )
    batch_size: int = 32
    max_tokens_per_mb: int = 16384
    tokenizer_path: Optional[str] = None
    trainer_device: str = ""              # "" = the card; "cpu"


# --------------------------------------------------------------------------- #
# YAML loading with dotted overrides
# --------------------------------------------------------------------------- #


def _from_dict(cls, d: Dict[str, Any]):
    if d is None:
        return None
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _DATACLASS_FIELDS.get((cls, f.name))
        if sub is not None and isinstance(v, dict):
            v = _from_dict(sub, v)
        kwargs[f.name] = v
    return cls(**kwargs)


_DATACLASS_FIELDS = {}


def _register_nested(cls):
    import typing

    known = {
        c.__name__: c
        for c in (
            ModelSpec, DatasetSpec, GenFleetSpec, RolloutSpec, ManagerSpec,
            TrainerControlSpec, PPOHyperparameters, GenerationHyperparameters,
            OptimizerConfig, EvaluatorSpec,
        )
    }
    for f in dataclasses.fields(cls):
        # resolve nested dataclass types (incl. Optional[X]) for the
        # dict->dataclass conversion in _from_dict
        t = f.type
        if isinstance(t, str):
            t = known.get(t.removeprefix("Optional[").removesuffix("]"))
        elif typing.get_origin(t) is typing.Union:
            args = [a for a in typing.get_args(t) if a is not type(None)]
            t = args[0] if len(args) == 1 else None
        if t is not None and dataclasses.is_dataclass(t):
            _DATACLASS_FIELDS[(cls, f.name)] = t


for _cls in (
    AsyncPPOExperiment, SyncPPOExperiment, SFTExperiment, RWExperiment,
    ModelSpec, RolloutSpec, GenFleetSpec, PPOHyperparameters, EvaluatorSpec,
):
    _register_nested(_cls)


def _apply_override(d: Dict[str, Any], dotted: str, value: str):
    keys = dotted.split(".")
    cur = d
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    try:
        value = json.loads(value)
    except (json.JSONDecodeError, TypeError):
        pass
    cur[keys[-1]] = value


def load_config(
    cls, yaml_path: Optional[str] = None, overrides: Optional[List[str]] = None
):
    """Build an experiment config from YAML + ``a.b=c`` overrides. PyYAML
    is imported only when a YAML path is given."""
    d: Dict[str, Any] = {}
    if yaml_path:
        import yaml

        with open(yaml_path) as f:
            d = yaml.safe_load(f) or {}
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        _apply_override(d, key, val)
    return _from_dict(cls, d)
