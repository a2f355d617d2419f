"""The name_resolve key layout of one experiment trial (the slice's subset of
``areal_tpu/base/names.py``, same keys): every component publishes and
discovers under ``areal_tpu/<experiment>/<trial>/...``, so a port process
and a reference process of one trial find each other.
"""

ROOT = "areal_tpu"


def trial_root(experiment_name: str, trial_name: str) -> str:
    return f"{ROOT}/{experiment_name}/{trial_name}"


def push_pull_stream(experiment_name, trial_name, stream_name) -> str:
    return f"{trial_root(experiment_name, trial_name)}/push_pull_stream/{stream_name}"


def push_pull_stream_root(experiment_name, trial_name) -> str:
    return f"{trial_root(experiment_name, trial_name)}/push_pull_stream"


def gen_servers(experiment_name, trial_name) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_servers"


def gen_server(experiment_name, trial_name, server_idx) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gen_servers/{server_idx}"


def gserver_manager(experiment_name, trial_name) -> str:
    return f"{trial_root(experiment_name, trial_name)}/gserver_manager"


def gateway(experiment_name, trial_name) -> str:
    """The OpenAI-compatible serving gateway's address."""
    return f"{trial_root(experiment_name, trial_name)}/gateway"


def model_version(experiment_name, trial_name, model_name) -> str:
    return f"{trial_root(experiment_name, trial_name)}/model_version/{model_name}"


def training_samples(experiment_name, trial_name) -> str:
    return f"{trial_root(experiment_name, trial_name)}/training_samples"


def worker_status(experiment_name, trial_name, worker_name) -> str:
    return f"{trial_root(experiment_name, trial_name)}/worker_status/{worker_name}"


def experiment_status(experiment_name, trial_name) -> str:
    return f"{trial_root(experiment_name, trial_name)}/experiment_status"


def telemetry(experiment_name, trial_name, worker_name) -> str:
    """Per-worker telemetry snapshot (JSON) published by the exporter."""
    return f"{trial_root(experiment_name, trial_name)}/telemetry/{worker_name}"


def telemetry_root(experiment_name, trial_name) -> str:
    return f"{trial_root(experiment_name, trial_name)}/telemetry"
