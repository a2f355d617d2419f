"""Profiling experiment: timed train steps on synthetic data (counterpart of
``areal_tpu/apps/profile.py``).

Runs N timed SFT steps of a given model on synthetic packed batches and
prints the mean step time, tokens/s, achieved TFLOP/s and MFU as one JSON
line, with the reference's keys:

    python -m areal_tpu_torch.apps.main profile --seqlens 1024x8 \
        --n-steps 3 [--device cpu] [--peak-flops F] arch='{...}'

``--device`` empty (the default) is the card, ``cpu`` the CPU. MFU is
against ``--peak-flops``, by default one H100's dense bf16 peak
(989 TFLOP/s, NVIDIA's data sheet, SXM part). ``AREAL_DUMP_TRACE`` asks
the reference for a trace of the timed steps; the port's tracing twin is
not there yet, so the knob is logged and ignored.
"""

import argparse
import json
import logging
import os
import sys
import time
from typing import List

logger = logging.getLogger("areal_tpu_torch.profile")

H100_BF16_PEAK_FLOPS = 989e12   # dense, SXM part


def run_profile(
    model_spec,
    seqlens: List[int],
    n_steps: int = 8,
    n_warmup: int = 2,  # >= 1: the first step allocates the optimizer state
    n_mbs: int = 1,
    peak_flops: float = H100_BF16_PEAK_FLOPS,
    seed: int = 0,
    device=None,
) -> dict:
    import numpy as np
    import torch

    from areal_tpu_torch.api.data import MicroBatchSpec, SequenceSample
    from areal_tpu_torch.base import flops as flops_mod
    from areal_tpu_torch.interfaces.sft import sft_loss_fn
    from areal_tpu_torch.train.engine import TrainEngine

    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if os.environ.get("AREAL_DUMP_TRACE"):
        logger.info("AREAL_DUMP_TRACE is set: the port has no tracing twin "
                    "yet, so no trace is written")
    cfg = model_spec.model_config()
    eng = TrainEngine(cfg, model_spec.parallel_config(), model_spec.optimizer,
                      device=device or None)
    eng.init_random(seed)
    eng.setup_optimizer(total_train_steps=max(n_steps * 10, 100))

    T = sum(seqlens)
    rng = np.random.default_rng(seed)
    sample = SequenceSample.from_default(
        ids=list(range(len(seqlens))),
        seqlens=list(seqlens),
        data={
            "packed_input_ids": rng.integers(0, cfg.vocab_size, T).astype(
                np.int64
            ),
            "prompt_mask": np.zeros(T, bool),
        },
    )
    spec = MicroBatchSpec(n_mbs=n_mbs, max_tokens_per_mb=T)

    def sync():
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)

    for _ in range(max(n_warmup, 1)):
        eng.train_batch(sample, spec, sft_loss_fn, fetch_stats=False)
    sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.train_batch(sample, spec, sft_loss_fn, fetch_stats=False)
    sync()
    dt = (time.perf_counter() - t0) / n_steps

    fl = flops_mod.train_flops(cfg, T, seqlens=seqlens)
    return {
        "metric": "profile_step",
        "step_time_s": round(dt, 5),
        "tokens_per_s": round(T / dt, 1),
        "tflops_per_s": round(fl / dt / 1e12, 2),
        "mfu": round(fl / dt / peak_flops, 4),
        "n_params": int(flops_mod.param_count(cfg)),
        "seqlens": list(seqlens),
        "n_steps": n_steps,
    }


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(prog="areal_tpu_torch profile")
    ap.add_argument("--config", default=None, help="YAML with a ModelSpec")
    ap.add_argument("--seqlens", default="512x8",
                    help="'LENxN' or comma list, e.g. 512x8 or 8192")
    ap.add_argument("--n-steps", type=int, default=8)
    ap.add_argument("--n-mbs", type=int, default=1)
    ap.add_argument("--peak-flops", type=float, default=H100_BF16_PEAK_FLOPS)
    ap.add_argument("--device", default="",
                    help="'' (the default) runs on the card, 'cpu' on the CPU")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    from areal_tpu_torch.experiments import load_config
    from areal_tpu_torch.experiments.config import ModelSpec

    spec = load_config(ModelSpec, args.config, args.overrides)
    if "x" in args.seqlens:
        ln, n = args.seqlens.split("x")
        seqlens = [int(ln)] * int(n)
    else:
        seqlens = [int(x) for x in args.seqlens.split(",")]
    out = run_profile(
        spec, seqlens, n_steps=args.n_steps, n_mbs=args.n_mbs,
        peak_flops=args.peak_flops, device=args.device,
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
