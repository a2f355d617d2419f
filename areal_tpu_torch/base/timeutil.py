"""Frequency control for save / eval / checkpoint ticks (a copy of
``areal_tpu/base/timeutil.py``): a tick fires when *any* of the epoch /
step / wall-clock-second frequencies elapses.
"""

import time
from typing import Optional


class EpochStepTimeFreqCtl:
    def __init__(
        self,
        freq_epoch: Optional[int] = None,
        freq_step: Optional[int] = None,
        freq_sec: Optional[float] = None,
    ):
        self.freq_epoch = freq_epoch
        self.freq_step = freq_step
        self.freq_sec = freq_sec
        self._epoch_count = 0
        self._step_count = 0
        self._last_time = time.monotonic()

    def check(self, epochs: int = 0, steps: int = 1) -> bool:
        self._epoch_count += epochs
        self._step_count += steps
        fire = False
        if self.freq_epoch and self._epoch_count >= self.freq_epoch:
            fire = True
        if self.freq_step and self._step_count >= self.freq_step:
            fire = True
        if self.freq_sec and time.monotonic() - self._last_time >= self.freq_sec:
            fire = True
        if fire:
            self._epoch_count = 0
            self._step_count = 0
            self._last_time = time.monotonic()
        return fire

    def state_dict(self):
        return dict(
            epoch_count=self._epoch_count,
            step_count=self._step_count,
        )

    def load_state_dict(self, state):
        self._epoch_count = state["epoch_count"]
        self._step_count = state["step_count"]
        self._last_time = time.monotonic()
