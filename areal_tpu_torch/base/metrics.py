"""Training metric sinks (the ``MetricLogger`` of
``areal_tpu/base/metrics.py``): one JSON line per logged step in
``<logdir>/metrics.jsonl`` (``{"step", "time", "<prefix>/<key>": ...}``,
the reference's layout), and TensorBoard scalars when ``tensorboardX``
imports. The process-global counter registry waits for the telemetry
twin.
"""

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger("areal_tpu_torch.metrics")


class MetricLogger:
    def __init__(self, logdir: str, backends: tuple = ("jsonl", "tensorboard")):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = None
        self._tb = None
        self._tb_failed_keys: set = set()
        if "jsonl" in backends:
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if "tensorboard" in backends:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir=os.path.join(logdir, "tb"))
            except ImportError:
                pass

    def log(
        self,
        data: Dict[str, float],
        step: int,
        prefix: Optional[str] = None,
        wall_time: Optional[float] = None,
    ):
        """``wall_time`` stamps a step with the time it ran when the
        trainer logs several steps at once."""
        if prefix:
            data = {f"{prefix}/{k}": v for k, v in data.items()}
        if self._jsonl:
            self._jsonl.write(
                json.dumps(
                    dict(
                        step=step,
                        time=time.time() if wall_time is None else wall_time,
                        **data,
                    )
                )
                + "\n"
            )
            self._jsonl.flush()
        if self._tb:
            for k, v in data.items():
                try:
                    self._tb.add_scalar(k, v, step, walltime=wall_time)
                except Exception:
                    if k not in self._tb_failed_keys:
                        self._tb_failed_keys.add(k)
                        logger.warning(
                            "tensorboard add_scalar(%r) failed; further "
                            "failures for this key are suppressed",
                            k, exc_info=True,
                        )

    def close(self):
        """Idempotent."""
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None
