"""Key-value store for service discovery and rendezvous (the slice's part
of ``areal_tpu/base/name_resolve.py``, same semantics):

- ``MemoryNameRecordRepository``: an in-process dict, for tests and
  single-process runs (the module default);
- ``FileNameRecordRepository``: a shared-filesystem store, one small text
  file per key, for runs of several processes;
- ``RpcNameRecordRepository``: a TCP client of the self-hosted
  ``base/name_resolve_server.py`` (newline-JSON, etcd-style keepalive
  leases), for several hosts without a shared filesystem. Its wire format
  is the reference's.

``add`` (with ``replace`` / ``delete_on_exit``), ``get``, ``wait`` (poll
until a key appears), ``delete``, ``clear_subtree``, ``get_subtree``,
``find_subtree``, ``watch_names`` and ``reset`` (drop everything this
process added). ``reconfigure(NameResolveConfig(type="file", root=...))``
(or ``type="rpc", root="host:port"``) swaps the module default, as the
launcher does in every process of a run.
"""

import dataclasses
import os
import random
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from areal_tpu_torch.base import constants, logging

logger = logging.getLogger("name_resolve")

ROOT_ENV = "AREAL_NAME_RESOLVE_ROOT"


class NameEntryExistsError(Exception):
    pass


class NameEntryNotFoundError(Exception):
    pass


class NameRecordRepository:
    """Abstract distributed KV store."""

    def add(self, name: str, value: str, delete_on_exit: bool = True,
            keepalive_ttl: Optional[float] = None, replace: bool = False):
        raise NotImplementedError()

    def get(self, name: str) -> str:
        raise NotImplementedError()

    def delete(self, name: str):
        raise NotImplementedError()

    def clear_subtree(self, name_root: str):
        raise NotImplementedError()

    def get_subtree(self, name_root: str) -> List[str]:
        raise NotImplementedError()

    def find_subtree(self, name_root: str) -> List[str]:
        """Sorted keys under ``name_root``."""
        raise NotImplementedError()

    def wait(self, name: str, timeout: Optional[float] = None,
             poll_frequency: float = 0.1) -> str:
        """Poll until ``name`` exists, then return its value."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self.get(name)
            except NameEntryNotFoundError:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"Timeout waiting for name_resolve key: {name}"
                    )
                time.sleep(poll_frequency + random.random() * 0.01)

    def add_subentry(self, name: str, value: str, **kwargs) -> str:
        """Add ``value`` under a fresh unique sub-key of ``name``."""
        sub = f"{name}/{random.randint(0, 2**31):010d}"
        self.add(sub, value, **kwargs)
        return sub

    def reset(self):
        """Delete every entry added (with delete_on_exit) by this repo."""
        raise NotImplementedError()

    def watch_names(
        self,
        names: List[str],
        call_back: Callable[[], None],
        poll_frequency: float = 5.0,
        wait_timeout: float = 300.0,
    ):
        """Spawn a daemon thread that fires ``call_back`` once any of
        ``names`` disappears (after having existed)."""
        if isinstance(names, str):
            names = [names]

        def _watch():
            for name in names:
                try:
                    self.wait(name, timeout=wait_timeout)
                except TimeoutError:
                    logger.warning("watch_names: %s never appeared", name)
                    call_back()
                    return
            while True:
                try:
                    for name in names:
                        self.get(name)
                except NameEntryNotFoundError:
                    call_back()
                    return
                time.sleep(poll_frequency)

        t = threading.Thread(target=_watch, daemon=True)
        t.start()
        return t


def _under(key: str, root: str) -> bool:
    return key == root or key.startswith(root + "/")


class MemoryNameRecordRepository(NameRecordRepository):
    def __init__(self):
        self._store: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._to_delete = set()

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None,
            replace=False):
        name = name.rstrip("/")
        with self._lock:
            if name in self._store and not replace:
                raise NameEntryExistsError(name)
            self._store[name] = str(value)
            if delete_on_exit:
                self._to_delete.add(name)

    def get(self, name):
        name = name.rstrip("/")
        with self._lock:
            if name not in self._store:
                raise NameEntryNotFoundError(name)
            return self._store[name]

    def delete(self, name):
        name = name.rstrip("/")
        with self._lock:
            if name not in self._store:
                raise NameEntryNotFoundError(name)
            del self._store[name]
            self._to_delete.discard(name)

    def clear_subtree(self, name_root):
        name_root = name_root.rstrip("/")
        with self._lock:
            for k in [k for k in self._store if _under(k, name_root)]:
                del self._store[k]
                self._to_delete.discard(k)

    def get_subtree(self, name_root):
        name_root = name_root.rstrip("/")
        with self._lock:
            # ordered by key so the result aligns with find_subtree
            return [v for k, v in sorted(self._store.items())
                    if _under(k, name_root)]

    def find_subtree(self, name_root):
        name_root = name_root.rstrip("/")
        with self._lock:
            return sorted(k for k in self._store if _under(k, name_root))

    def reset(self):
        with self._lock:
            for k in list(self._to_delete):
                self._store.pop(k, None)
            self._to_delete.clear()


class FileNameRecordRepository(NameRecordRepository):
    """Shared-filesystem KV store: key -> ``<root>/<key>/__value__``. The
    root defaults to ``AREAL_NAME_RESOLVE_ROOT``, else a directory under
    the process's temporary directory."""

    VALUE_FILE = "__value__"

    def __init__(self, root: Optional[str] = None):
        if root is None:
            root = os.environ.get(ROOT_ENV) or os.path.join(
                tempfile.gettempdir(), "areal_tpu_torch", "name_resolve")
        self._root = root
        self._to_delete = set()
        self._lock = threading.Lock()

    def _path(self, name: str) -> str:
        return os.path.join(self._root, name.strip("/"), self.VALUE_FILE)

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None,
            replace=False):
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if replace:
            tmp = path + f".tmp.{os.getpid()}.{random.randint(0, 1 << 30)}"
            with open(tmp, "w") as f:
                f.write(str(value))
            os.replace(tmp, path)  # atomic on POSIX
        else:
            # O_EXCL makes create-if-absent atomic across processes
            try:
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL)
            except FileExistsError:
                raise NameEntryExistsError(name) from None
            with os.fdopen(fd, "w") as f:
                f.write(str(value))
        if delete_on_exit:
            with self._lock:
                self._to_delete.add(name)

    def get(self, name):
        try:
            with open(self._path(name), "r") as f:
                return f.read()
        except FileNotFoundError:
            raise NameEntryNotFoundError(name) from None

    def delete(self, name):
        path = self._path(name)
        try:
            os.remove(path)
        except FileNotFoundError:
            raise NameEntryNotFoundError(name) from None
        with self._lock:
            self._to_delete.discard(name)
        try:  # best-effort cleanup of empty dirs
            os.removedirs(os.path.dirname(path))
        except OSError:
            pass

    def clear_subtree(self, name_root):
        path = os.path.join(self._root, name_root.strip("/"))
        # arealint: ok(name-resolve KV subtree under self._root, never a checkpoint dir)
        shutil.rmtree(path, ignore_errors=True)
        root = name_root.rstrip("/")
        with self._lock:
            self._to_delete = {n for n in self._to_delete
                               if not _under(n, root)}

    def _walk(self, name_root):
        base = os.path.join(self._root, name_root.strip("/"))
        found = []
        if os.path.isfile(os.path.join(base, self.VALUE_FILE)):
            found.append(name_root.strip("/"))
        for dirpath, _, filenames in os.walk(base):
            if self.VALUE_FILE in filenames and dirpath != base:
                found.append(os.path.relpath(dirpath, self._root))
        return sorted(set(found))

    def get_subtree(self, name_root):
        return [self.get(k) for k in self._walk(name_root)]

    def find_subtree(self, name_root):
        return self._walk(name_root)

    def reset(self):
        with self._lock:
            names = list(self._to_delete)
            self._to_delete.clear()
        for name in names:
            try:
                self.delete(name)
            except NameEntryNotFoundError:
                pass


class RpcNameRecordRepository(NameRecordRepository):
    """TCP rendezvous backend (``base/name_resolve_server.py``): several
    hosts without a shared filesystem and without etcd. One persistent socket
    (newline-JSON protocol) with reconnect; a daemon thread refreshes the
    lease of every key added with ``keepalive_ttl`` (etcd-style: a dead
    process's keys expire, which is what death-watches rely on).

    Address: ``host:port``, from the config root or
    ``AREAL_NAME_RESOLVE_RPC``.
    """

    def __init__(self, address: Optional[str] = None):
        import socket as _socket

        address = address or constants.name_resolve_rpc()
        if not address or ":" not in address:
            raise ValueError(
                "rpc name_resolve needs 'host:port' (config root or "
                "AREAL_NAME_RESOLVE_RPC)"
            )
        host, _, port = address.rpartition(":")
        self._addr = (host, int(port))
        self._socket_mod = _socket
        self._sock = None
        self._rfile = None
        self._lock = threading.Lock()
        self._to_delete = set()
        self._leases: Dict[str, float] = {}      # name -> ttl
        self._lease_values: Dict[str, str] = {}  # name -> value (for re-add)
        self._keepalive: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _connect_locked(self):
        if self._sock is not None:
            return
        s = self._socket_mod.create_connection(self._addr, timeout=10.0)
        s.settimeout(30.0)
        self._sock = s
        self._rfile = s.makefile("rb")

    # ops safe to blindly re-send after a lost reply; mutating ops are NOT:
    # a retried add whose first attempt landed would raise a spurious
    # NameEntryExistsError for the caller's own key
    _IDEMPOTENT = frozenset({"get", "get_subtree", "find_subtree", "touch",
                             "ping"})

    def _call(self, req: dict) -> dict:
        import json as _json

        with self._lock:
            for attempt in (0, 1):
                sent = False
                try:
                    self._connect_locked()
                    self._sock.sendall((_json.dumps(req) + "\n").encode())
                    sent = True
                    line = self._rfile.readline()
                    if not line:
                        raise ConnectionError("server closed connection")
                    return _json.loads(line)
                except (OSError, ConnectionError):
                    self._sock = None
                    if attempt or (sent and req["op"] not in self._IDEMPOTENT):
                        raise

    def _ensure_keepalive(self):
        if self._keepalive is not None:
            return

        def _loop():
            while not self._stop.wait(1.0):
                with self._lock:
                    leases = dict(self._leases)
                if not leases:
                    continue
                # one touch per distinct TTL — refreshing every key with
                # the minimum would silently shorten longer leases
                by_ttl: Dict[float, List[str]] = {}
                for n, t in leases.items():
                    by_ttl.setdefault(t, []).append(n)
                for ttl, names in by_ttl.items():
                    try:
                        resp = self._call(
                            {"op": "touch", "names": names, "ttl": ttl}
                        )
                        # a lease that lapsed (we stalled past the TTL) is
                        # gone for good server-side; re-ADD it — an explicit
                        # re-registration after the death-watch window
                        for n in resp.get("missing", []):
                            with self._lock:
                                value = self._lease_values.get(n)
                            if value is not None:
                                self._call({
                                    "op": "add", "name": n, "value": value,
                                    "replace": True, "ttl": ttl,
                                })
                    except Exception:  # noqa: BLE001 - retried next tick
                        pass

        self._keepalive = threading.Thread(target=_loop, daemon=True)
        self._keepalive.start()

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None,
            replace=False):
        name = name.rstrip("/")
        resp = self._call({
            "op": "add", "name": name, "value": str(value),
            "replace": replace, "ttl": keepalive_ttl,
        })
        if not resp["ok"]:
            if resp.get("error") == "exists":
                raise NameEntryExistsError(name)
            raise RuntimeError(
                f"name_resolve add({name!r}) failed: {resp.get('error')}"
            )
        if delete_on_exit:
            self._to_delete.add(name)
        if keepalive_ttl:
            with self._lock:
                self._leases[name] = float(keepalive_ttl)
                self._lease_values[name] = str(value)
            self._ensure_keepalive()

    def get(self, name):
        resp = self._call({"op": "get", "name": name.rstrip("/")})
        if not resp["ok"]:
            raise NameEntryNotFoundError(name)
        return resp["value"]

    def delete(self, name):
        name = name.rstrip("/")
        resp = self._call({"op": "delete", "name": name})
        self._to_delete.discard(name)
        with self._lock:
            self._leases.pop(name, None)
            self._lease_values.pop(name, None)
        if not resp["ok"]:
            raise NameEntryNotFoundError(name)

    def clear_subtree(self, name_root):
        self._call({"op": "clear_subtree", "name": name_root.rstrip("/")})
        root = name_root.rstrip("/")
        self._to_delete = {
            n for n in self._to_delete
            if not (n == root or n.startswith(root + "/"))
        }

    def get_subtree(self, name_root):
        return self._call(
            {"op": "get_subtree", "name": name_root.rstrip("/")}
        )["values"]

    def find_subtree(self, name_root):
        return self._call(
            {"op": "find_subtree", "name": name_root.rstrip("/")}
        )["keys"]

    def reset(self):
        names = list(self._to_delete)
        self._to_delete.clear()
        with self._lock:
            self._leases.clear()
            self._lease_values.clear()
        if names:
            self._call({"op": "delete_many", "names": names})

    def close(self):
        self._stop.set()
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


@dataclasses.dataclass
class NameResolveConfig:
    type: str = "file"  # "memory" | "file" | "rpc"
    root: Optional[str] = None  # file: directory; rpc: "host:port"


_DEFAULT: NameRecordRepository = MemoryNameRecordRepository()


def make_repository(cfg: NameResolveConfig) -> NameRecordRepository:
    if cfg.type == "memory":
        return MemoryNameRecordRepository()
    if cfg.type == "file":
        return FileNameRecordRepository(cfg.root)
    if cfg.type == "rpc":
        return RpcNameRecordRepository(cfg.root)
    raise ValueError(f"Unknown name_resolve backend: {cfg.type}")


def reconfigure(cfg: NameResolveConfig):
    """Swap the module-level default repository."""
    global _DEFAULT
    _DEFAULT = make_repository(cfg)


def default_repository() -> NameRecordRepository:
    return _DEFAULT


def set_repository(repo: NameRecordRepository):
    """Install ``repo`` as the module default (a
    ``FileNameRecordRepository`` for a run of several processes)."""
    global _DEFAULT
    _DEFAULT = repo


# module-level API in the reference's usage style (``name_resolve.add``)
def add(*args, **kwargs):
    return _DEFAULT.add(*args, **kwargs)


def add_subentry(*args, **kwargs):
    return _DEFAULT.add_subentry(*args, **kwargs)


def get(*args, **kwargs):
    return _DEFAULT.get(*args, **kwargs)


def wait(*args, **kwargs):
    return _DEFAULT.wait(*args, **kwargs)


def delete(*args, **kwargs):
    return _DEFAULT.delete(*args, **kwargs)


def clear_subtree(*args, **kwargs):
    return _DEFAULT.clear_subtree(*args, **kwargs)


def get_subtree(*args, **kwargs):
    return _DEFAULT.get_subtree(*args, **kwargs)


def find_subtree(*args, **kwargs):
    return _DEFAULT.find_subtree(*args, **kwargs)


def watch_names(*args, **kwargs):
    return _DEFAULT.watch_names(*args, **kwargs)


def reset():
    return _DEFAULT.reset()
