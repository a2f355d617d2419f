"""Experiment configuration layer: dataclass configs plus YAML and dotted
overrides, compiled into worker processes by the launcher
(``areal_tpu_torch/apps/launcher.py``)."""

from areal_tpu_torch.experiments.config import (  # noqa: F401
    AsyncPPOExperiment,
    DatasetSpec,
    EvaluatorSpec,
    GatewaySpec,
    GenFleetSpec,
    ManagerSpec,
    ModelSpec,
    RolloutSpec,
    RWExperiment,
    SFTExperiment,
    SyncPPOExperiment,
    TrainerControlSpec,
    load_config,
)
