"""Trainer-side stream dataset: a dataset facade over the rollout puller
(the counterpart of ``areal_tpu/system/stream_dataset.py``). A background
thread pulls JSON trajectories and converts them to ``SequenceSample``;
``__len__`` reports the offline dataset's size so epoch accounting stays
meaningful.
"""

import logging
import queue
import threading
from queue import Empty
from typing import List, Optional

from areal_tpu_torch.api.data import SequenceSample
from areal_tpu_torch.system.push_pull_stream import NameResolvingJsonPuller

logger = logging.getLogger("areal_tpu_torch.stream_dataset")


class PullerStreamDataset:
    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        puller_index: int,
        offline_dataset_size: int,
        pull_timeout_ms: int = 100,
        max_buffer: int = 10000,
        puller: Optional[object] = None,
    ):
        self._size = offline_dataset_size
        self._queue: queue.Queue = queue.Queue(maxsize=max_buffer)
        self._puller = puller or NameResolvingJsonPuller(
            experiment_name, trial_name, puller_index,
            default_timeout_ms=pull_timeout_ms,
        )
        self.dropped = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pull_loop, daemon=True)
        self._thread.start()

    def _pull_loop(self):
        while not self._stop.is_set():
            try:
                d = self._puller.pull()
            except Empty:
                continue
            except Exception:
                logger.exception("pull failed")
                continue
            try:
                self._queue.put(SequenceSample.from_json_compatible(d), timeout=5)
            except queue.Full:
                self.dropped += 1
                logger.warning("stream buffer full; dropping trajectory")

    def get_batch(self, max_samples: int, timeout: float = 0.1) -> List[SequenceSample]:
        out = []
        try:
            out.append(self._queue.get(timeout=timeout))
            while len(out) < max_samples:
                out.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        return out

    def clear(self) -> int:
        """Drop everything buffered; returns the count."""
        n = 0
        while True:
            try:
                self._queue.get_nowait()
                n += 1
            except queue.Empty:
                return n

    def qsize(self) -> int:
        return self._queue.qsize()

    def __len__(self):
        return self._size

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
        self._puller.close()
