"""Self-hosted rendezvous server for the ``rpc`` name_resolve backend (the
counterpart of ``areal_tpu/base/name_resolve_server.py``, on the same wire
format, so either package's client talks to either package's server).

For several hosts without a shared writable filesystem and without etcd or
Redis: one small threaded TCP server holding the key tree, speaking
newline-delimited JSON. The launcher (or any process)
starts it once and exports ``AREAL_NAME_RESOLVE_RPC=host:port``; every
worker's ``RpcNameRecordRepository`` talks to it.

Protocol — one JSON object per line, one reply per request:
  {"op": "add", "name", "value", "replace": bool, "ttl": float|null}
  {"op": "touch", "names": [...], "ttl": float}      # lease keepalive
  {"op": "get"|"delete", "name"}
  {"op": "get_subtree"|"find_subtree"|"clear_subtree", "name"}
  {"op": "delete_many", "names": [...]}              # client reset()
Replies: {"ok": true, ...} or {"ok": false, "error": "exists"|"not_found"}.

TTL semantics mirror etcd leases: a key added with ``keepalive_ttl``
expires unless touched; the client runs the keepalive thread (as an etcd
lease refresh), so a dead worker's keys vanish, which is what a
death-watch relies on.

Run standalone:  python -m areal_tpu_torch.base.name_resolve_server --port 7777
"""

import argparse
import json
import socket
import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple


class _Store:
    """KV tree + lazy TTL expiry (guarded by one lock; ops are tiny)."""

    def __init__(self):
        self._kv: Dict[str, str] = {}
        self._expiry: Dict[str, float] = {}
        self._lock = threading.Lock()

    def _expire_locked(self):
        now = time.monotonic()
        for k in [k for k, t in self._expiry.items() if t < now]:
            self._kv.pop(k, None)
            self._expiry.pop(k, None)

    def add(self, name: str, value: str, replace: bool, ttl: Optional[float]):
        name = name.rstrip("/")
        with self._lock:
            self._expire_locked()
            if name in self._kv and not replace:
                return {"ok": False, "error": "exists"}
            self._kv[name] = value
            if ttl:
                self._expiry[name] = time.monotonic() + ttl
            else:
                self._expiry.pop(name, None)
            return {"ok": True}

    def touch(self, names: List[str], ttl: float):
        with self._lock:
            # expire first: a keepalive arriving after the lease lapsed must
            # NOT resurrect the key — death-watchers rely on expiry being
            # final. Lapsed names are reported back so the (live) client can
            # re-ADD them, which is an explicit re-registration.
            self._expire_locked()
            now = time.monotonic()
            missing = []
            for n in names:
                n = n.rstrip("/")
                if n in self._kv:
                    self._expiry[n] = now + ttl
                else:
                    missing.append(n)
            return {"ok": True, "missing": missing}

    def get(self, name: str):
        name = name.rstrip("/")
        with self._lock:
            self._expire_locked()
            if name not in self._kv:
                return {"ok": False, "error": "not_found"}
            return {"ok": True, "value": self._kv[name]}

    def delete(self, name: str):
        name = name.rstrip("/")
        with self._lock:
            self._expire_locked()
            if name not in self._kv:
                return {"ok": False, "error": "not_found"}
            del self._kv[name]
            self._expiry.pop(name, None)
            return {"ok": True}

    def delete_many(self, names: List[str]):
        with self._lock:
            for n in names:
                n = n.rstrip("/")
                self._kv.pop(n, None)
                self._expiry.pop(n, None)
            return {"ok": True}

    def _subtree_keys_locked(self, root: str) -> List[str]:
        root = root.rstrip("/")
        return sorted(
            k for k in self._kv if k == root or k.startswith(root + "/")
        )

    def get_subtree(self, name: str):
        with self._lock:
            self._expire_locked()
            return {
                "ok": True,
                "values": [
                    self._kv[k] for k in self._subtree_keys_locked(name)
                ],
            }

    def find_subtree(self, name: str):
        with self._lock:
            self._expire_locked()
            return {"ok": True, "keys": self._subtree_keys_locked(name)}

    def clear_subtree(self, name: str):
        with self._lock:
            for k in self._subtree_keys_locked(name):
                del self._kv[k]
                self._expiry.pop(k, None)
            return {"ok": True}


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        store: _Store = self.server.store  # type: ignore[attr-defined]
        while True:
            line = self.rfile.readline()
            if not line:
                return
            try:
                req = json.loads(line)
                op = req["op"]
                if op == "add":
                    resp = store.add(
                        req["name"], req["value"],
                        bool(req.get("replace")), req.get("ttl"),
                    )
                elif op == "touch":
                    resp = store.touch(req["names"], float(req["ttl"]))
                elif op == "get":
                    resp = store.get(req["name"])
                elif op == "delete":
                    resp = store.delete(req["name"])
                elif op == "delete_many":
                    resp = store.delete_many(req["names"])
                elif op == "get_subtree":
                    resp = store.get_subtree(req["name"])
                elif op == "find_subtree":
                    resp = store.find_subtree(req["name"])
                elif op == "clear_subtree":
                    resp = store.clear_subtree(req["name"])
                elif op == "ping":
                    resp = {"ok": True}
                else:
                    resp = {"ok": False, "error": f"bad op {op!r}"}
            except Exception as e:  # noqa: BLE001 - malformed request
                resp = {"ok": False, "error": f"bad request: {e!r}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class NameResolveServer:
    """Embeddable server: ``addr = NameResolveServer().start()``."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=False
        )
        self._srv.allow_reuse_address = True
        self._srv.daemon_threads = True
        self._srv.store = _Store()  # type: ignore[attr-defined]
        self._srv.server_bind()
        self._srv.server_activate()
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._srv.server_address[:2]
        if host == "0.0.0.0":
            host = socket.gethostbyname(socket.gethostname())
        return host, port

    def start(self) -> str:
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        return "%s:%d" % self.address

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7777)
    args = ap.parse_args(argv)
    srv = NameResolveServer(args.host, args.port)
    addr = srv.start()
    print(f"name_resolve rpc server on {addr}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
