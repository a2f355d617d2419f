"""Command-line entry point (the counterpart of ``areal_tpu/apps/main.py``):

    python -m areal_tpu_torch.apps.main async-ppo [--config cfg.yaml] \
        actor.arch='{"n_layers": 2, ...}' gen.device=cpu trainer_device=cpu
    python -m areal_tpu_torch.apps.main sft --config cfg.yaml model.path=...
    python -m areal_tpu_torch.apps.main profile --seqlens 512x8 --device cpu

``async-ppo`` launches the multiprocess world of
``apps/launcher.py::run_async_ppo``; ``sft``, ``sync-ppo`` and ``rw`` run
in this process on ``trainer_device`` (``""`` = the card); ``profile``
forwards its own arguments to ``apps/profile.py``.
"""

import argparse
import logging
import sys


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    parser = argparse.ArgumentParser(prog="areal_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for cmd in ("sft", "async-ppo", "sync-ppo", "rw"):
        p = sub.add_parser(cmd)
        p.add_argument("--config", default=None, help="YAML config path")
        p.add_argument(
            "overrides", nargs="*", help="dotted overrides, e.g. a.b=1"
        )
    sub.add_parser(
        "profile",
        description="timed train steps on synthetic data (see apps/profile.py)",
    )
    # profile owns its full argument surface (apps/profile.py): parse only
    # the subcommand here and forward the rest
    args, rest = parser.parse_known_args(argv)
    if args.cmd == "profile":
        from areal_tpu_torch.apps.profile import main as profile_main

        return profile_main(rest)
    if rest:  # only profile forwards unknown args
        parser.error(f"unrecognized arguments: {' '.join(rest)}")

    from areal_tpu_torch.apps import launcher
    from areal_tpu_torch.experiments import (
        AsyncPPOExperiment,
        RWExperiment,
        SFTExperiment,
        SyncPPOExperiment,
        load_config,
    )

    if args.cmd == "sft":
        cfg = load_config(SFTExperiment, args.config, args.overrides)
        return launcher.run_sft(cfg)
    if args.cmd == "rw":
        cfg = load_config(RWExperiment, args.config, args.overrides)
        return launcher.run_rw(cfg)
    if args.cmd == "sync-ppo":
        cfg = load_config(SyncPPOExperiment, args.config, args.overrides)
        return launcher.run_sync_ppo(cfg)
    cfg = load_config(AsyncPPOExperiment, args.config, args.overrides)
    return launcher.run_async_ppo(cfg)


if __name__ == "__main__":
    sys.exit(main())
