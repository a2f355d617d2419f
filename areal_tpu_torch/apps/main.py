"""Command-line entry point (the counterpart of ``areal_tpu/apps/main.py``):

    python -m areal_tpu_torch.apps.main async-ppo [--config cfg.yaml] \
        actor.arch='{"n_layers": 2, ...}' gen.device=cpu trainer_device=cpu

``async-ppo`` launches the multiprocess world of
``apps/launcher.py::run_async_ppo``. The reference's ``sft``,
``sync-ppo``, ``rw`` and ``profile`` subcommands exit with an error until
their entry points are ported.
"""

import argparse
import logging
import sys

NOT_PORTED = ("sft", "sync-ppo", "rw", "profile")


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    parser = argparse.ArgumentParser(prog="areal_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("async-ppo")
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("overrides", nargs="*", help="dotted overrides, e.g. a.b=1")
    for cmd in NOT_PORTED:
        sub.add_parser(cmd, add_help=False)
    args, rest = parser.parse_known_args(argv)
    if args.cmd in NOT_PORTED:
        parser.exit(2, f"areal_tpu_torch: the {args.cmd!r} entry point is not "
                       "ported yet (ROADMAP.md); only 'async-ppo' is\n")
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")

    from areal_tpu_torch.apps import launcher
    from areal_tpu_torch.experiments import AsyncPPOExperiment, load_config

    cfg = load_config(AsyncPPOExperiment, args.config, args.overrides)
    return launcher.run_async_ppo(cfg)


if __name__ == "__main__":
    sys.exit(main())
