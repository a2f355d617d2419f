"""Key-value store for service discovery and rendezvous (the slice's part
of ``areal_tpu/base/name_resolve.py``, same semantics):

- ``MemoryNameRecordRepository``: an in-process dict, for tests and
  single-process runs (the module default);
- ``FileNameRecordRepository``: a shared-filesystem store, one small text
  file per key, for runs of several processes.

``add`` (with ``replace`` / ``delete_on_exit``), ``get``, ``wait`` (poll
until a key appears), ``delete``, ``clear_subtree``, ``get_subtree``,
``find_subtree`` and ``reset`` (drop everything this process added).
``reconfigure(NameResolveConfig(type="file", root=...))`` swaps the module
default, as the launcher does in every process of a run. The reference's
TCP backend (``type="rpc"``) is not ported.
"""

import dataclasses
import os
import random
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

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


@dataclasses.dataclass
class NameResolveConfig:
    type: str = "file"  # "memory" | "file"
    root: Optional[str] = None  # file: directory


_DEFAULT: NameRecordRepository = MemoryNameRecordRepository()


def make_repository(cfg: NameResolveConfig) -> NameRecordRepository:
    if cfg.type == "memory":
        return MemoryNameRecordRepository()
    if cfg.type == "file":
        return FileNameRecordRepository(cfg.root)
    if cfg.type == "rpc":
        raise NotImplementedError(
            "the TCP name-resolve backend is not ported yet (ROADMAP.md)")
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


def reset():
    return _DEFAULT.reset()
