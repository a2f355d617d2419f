"""JSON push/pull streams, the rollout -> trainer data plane (the
counterpart of ``areal_tpu/system/push_pull_stream.py``) on the standard
library: length-prefixed JSON frames over TCP where the reference uses ZMQ
PUSH/PULL. N rollout workers push, M trainer-side pullers pull, and
addresses rendezvous through name_resolve.

The reference's contract, kept:

- ``push`` never blocks: it puts the frame on a bounded queue (``hwm``)
  that a sender thread drains. When the queue is full (the puller is dead
  or backlogged) it drops the trajectory, counts it in ``drop_cnt`` and
  returns False, so a dead trainer degrades to counted drops and never
  wedges the rollout worker's event loop.
- A pusher may start before its puller: the sender thread keeps
  connecting until the puller listens, then delivers what queued.
- ``pull(timeout_ms)`` raises ``queue.Empty`` when nothing arrived.

The reference's class names stay as aliases (``ZMQJsonPusher``,
``ZMQJsonPuller``, ``NameResolvingZmqPusher``, ``NameResolvingZmqPuller``).
"""

import json
import logging
import queue
import socket
import struct
import threading
from queue import Empty
from typing import Any, Dict, List, Optional

from areal_tpu_torch.base import name_resolve, names, network

logger = logging.getLogger("areal_tpu_torch.push_pull_stream")

_LEN = struct.Struct("!I")   # frame header: payload bytes, big-endian


class JsonPusher:
    def __init__(self, host: str, port: int, hwm: int = 1000,
                 connect_retry_s: float = 0.05):
        self.addr = (host, port)
        self.drop_cnt = 0
        self.sent_cnt = 0
        self._queue: queue.Queue = queue.Queue(maxsize=hwm)
        self._retry_s = connect_retry_s
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread = threading.Thread(target=self._send_loop, daemon=True,
                                        name="json-pusher")
        self._thread.start()

    def push(self, data: Any) -> bool:
        """Queue one JSON-serializable object; False (dropped, counted)
        when the queue is full. Never blocks."""
        frame = json.dumps(data).encode("utf-8")
        try:
            self._queue.put_nowait(_LEN.pack(len(frame)) + frame)
            return True
        except queue.Full:
            self.drop_cnt += 1
            logger.warning(
                "push queue full (puller dead or backlogged); dropped "
                "trajectory (%d drops so far)", self.drop_cnt,
            )
            return False

    def _connect(self) -> Optional[socket.socket]:
        while not self._stop.is_set():
            try:
                return socket.create_connection(self.addr, timeout=5)
            except OSError:
                self._stop.wait(self._retry_s)
        return None

    def _send_loop(self):
        frame = None
        while not self._stop.is_set():
            if frame is None:
                try:
                    frame = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            if self._sock is None:
                self._sock = self._connect()
                if self._sock is None:
                    return
                self._sock.settimeout(None)
            try:
                self._sock.sendall(frame)
                self.sent_cnt += 1
                frame = None
            except OSError:
                # the puller went away: reconnect and resend this frame
                self._sock.close()
                self._sock = None

    def close(self):
        """Stop sending; frames still queued are discarded (the reference
        closes with linger 0)."""
        self._stop.set()
        sock = self._sock
        if sock is not None:
            try:  # unblocks a sendall stuck on a backlogged puller
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join()
        if self._sock is not None:
            self._sock.close()


class JsonPuller:
    def __init__(self, host: str, port: int, hwm: int = 1000,
                 default_timeout_ms: int = 1000):
        self.default_timeout_ms = default_timeout_ms
        self._queue: queue.Queue = queue.Queue(maxsize=hwm)
        self._stop = threading.Event()
        self._lsock = socket.create_server(("" if host == "*" else host, port))
        self._lsock.settimeout(0.1)
        self.port = self._lsock.getsockname()[1]
        self._conns: List[socket.socket] = []
        self._threads = [threading.Thread(target=self._accept_loop,
                                          daemon=True, name="json-puller")]
        self._threads[0].start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(0.1)
            self._conns.append(conn)
            t = threading.Thread(target=self._recv_loop, args=(conn,),
                                 daemon=True, name="json-puller-conn")
            self._threads.append(t)
            t.start()

    def _recv_loop(self, conn: socket.socket):
        buf = bytearray()
        while not self._stop.is_set():
            try:
                chunk = conn.recv(1 << 20)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while len(buf) >= _LEN.size:
                (n,) = _LEN.unpack_from(buf)
                if len(buf) < _LEN.size + n:
                    break
                frame = bytes(buf[_LEN.size:_LEN.size + n])
                del buf[:_LEN.size + n]
                # a full queue blocks this reader: TCP backpressure fills the
                # pusher's queue, which drops and counts
                while not self._stop.is_set():
                    try:
                        self._queue.put(frame, timeout=0.1)
                        break
                    except queue.Full:
                        continue

    def pull(self, timeout_ms: Optional[int] = None) -> Any:
        t = self.default_timeout_ms if timeout_ms is None else timeout_ms
        frame = self._queue.get(timeout=t / 1000.0)  # raises queue.Empty
        return json.loads(frame.decode("utf-8"))

    def close(self):
        self._stop.set()
        self._lsock.close()
        for t in self._threads:
            t.join()
        for c in self._conns:
            c.close()


def grouping(n_pushers: int, n_pullers: int) -> Dict[int, List[int]]:
    """Assign pushers to pullers round-robin."""
    out: Dict[int, List[int]] = {i: [] for i in range(n_pullers)}
    for i in range(n_pushers):
        out[i % n_pullers].append(i)
    return out


class NameResolvingJsonPuller(JsonPuller):
    """Binds a free port and publishes it under the stream name."""

    def __init__(self, experiment_name: str, trial_name: str,
                 puller_index: int, **kw):
        super().__init__("*", 0, **kw)
        name = names.push_pull_stream(experiment_name, trial_name,
                                      f"puller{puller_index}")
        name_resolve.add(name, f"{network.gethostip()}:{self.port}",
                         replace=True)


class NameResolvingJsonPusher(JsonPusher):
    """Connects to its assigned puller (by pusher/puller grouping)."""

    def __init__(self, experiment_name: str, trial_name: str,
                 pusher_index: int, n_pushers: int, n_pullers: int, **kw):
        groups = grouping(n_pushers, n_pullers)
        puller_index = next(p for p, pushers in groups.items()
                            if pusher_index in pushers)
        name = names.push_pull_stream(experiment_name, trial_name,
                                      f"puller{puller_index}")
        host, port = name_resolve.wait(name, timeout=60).rsplit(":", 1)
        super().__init__(host, int(port), **kw)


# the reference's names for the same endpoints
ZMQJsonPusher = JsonPusher
ZMQJsonPuller = JsonPuller
NameResolvingZmqPusher = NameResolvingJsonPusher
NameResolvingZmqPuller = NameResolvingJsonPuller

__all__ = [
    "Empty", "JsonPusher", "JsonPuller", "grouping", "NameResolvingJsonPuller",
    "NameResolvingJsonPusher", "ZMQJsonPusher", "ZMQJsonPuller",
    "NameResolvingZmqPusher", "NameResolvingZmqPuller",
]
