"""The TCP name-resolve backend of the port
(``areal_tpu_torch/base/name_resolve_server.py`` and
``name_resolve.RpcNameRecordRepository``) against ``areal_tpu``'s: the wire
format is the reference's, so the port's client works against the
reference's server and the reference's client against the port's, for
add / get / subtree / delete / reset, lease expiry, keepalive and
``watch_names``; and the launcher's async-PPO world on the CPU rendezvous
through the port's server.
"""

import json
import os
import threading
import time

import pytest

from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.base import name_resolve_server as ref_srv
from areal_tpu_torch.base import name_resolve as pt_nr
from areal_tpu_torch.base import name_resolve_server as pt_srv

SERVERS = {"port": pt_srv, "ref": ref_srv}
CLIENTS = {"port": pt_nr, "ref": ref_nr}
PAIRS = [("port", "ref"), ("ref", "port"), ("port", "port")]


@pytest.fixture(scope="module")
def servers():
    out = {}
    for name, mod in SERVERS.items():
        srv = mod.NameResolveServer("127.0.0.1", 0)
        out[name] = (srv, srv.start())
    yield {k: v[1] for k, v in out.items()}
    for srv, _ in out.values():
        srv.stop()


def _client(client, addr):
    mod = CLIENTS[client]
    return mod.make_repository(mod.NameResolveConfig(type="rpc", root=addr))


@pytest.mark.parametrize("client,server", PAIRS)
def test_add_get_subtree_and_reset_across_packages(servers, client, server):
    mod = CLIENTS[client]
    prefix = f"x/{client}-{server}"
    a, b = _client(client, servers[server]), _client(client, servers[server])
    a.add(f"{prefix}/fleet/0", "http://h0:1", replace=True)
    b.add(f"{prefix}/fleet/1", "http://h1:1", replace=True)
    a.add(f"{prefix}/keep", "k", delete_on_exit=False)
    assert a.get(f"{prefix}/fleet/0/") == "http://h0:1"
    assert a.get_subtree(f"{prefix}/fleet") == ["http://h0:1", "http://h1:1"]
    assert b.find_subtree(f"{prefix}/fleet") == [
        f"{prefix}/fleet/0", f"{prefix}/fleet/1"]
    with pytest.raises(mod.NameEntryExistsError):
        a.add(f"{prefix}/fleet/0", "again")
    sub = a.add_subentry(f"{prefix}/subs", "s")
    assert a.get(sub) == "s"
    a.reset()           # only a's delete_on_exit keys go
    with pytest.raises(mod.NameEntryNotFoundError):
        b.get(f"{prefix}/fleet/0")
    assert b.get(f"{prefix}/fleet/1") == "http://h1:1"
    assert b.get(f"{prefix}/keep") == "k"
    b.delete(f"{prefix}/keep")
    with pytest.raises(mod.NameEntryNotFoundError):
        b.delete(f"{prefix}/keep")
    assert b.wait(f"{prefix}/fleet/1", timeout=1) == "http://h1:1"
    with pytest.raises(TimeoutError):
        b.wait(f"{prefix}/never", timeout=0.2, poll_frequency=0.05)
    b.clear_subtree(prefix)
    assert b.find_subtree(prefix) == []
    a.close(), b.close()


@pytest.mark.parametrize("client,server", PAIRS[:2])
def test_a_lease_lives_with_its_keepalive_and_expires_without(
        servers, client, server):
    key = f"hb/{client}-{server}"
    owner = _client(client, servers[server])
    other = _client("port" if client == "ref" else "ref", servers[server])
    owner.add(key, "alive", keepalive_ttl=1.0)
    time.sleep(1.8)                      # > ttl: the keepalive held it
    assert other.get(key) == "alive"
    # the owner dies; a keepalive tick already under way may still land
    # (it runs once a second), then the lease lapses
    owner.close()
    time.sleep(2.8)
    with pytest.raises((pt_nr.NameEntryNotFoundError,
                        ref_nr.NameEntryNotFoundError)):
        other.get(key)
    other.close()


def test_the_stores_agree_on_expiry_and_touch():
    """A keepalive after the lease lapsed does not revive the key; the
    lapsed name is reported back for re-registration, in both stores."""
    for mod in (pt_srv, ref_srv):
        st = mod._Store()
        st.add("hb/w0", "alive", replace=True, ttl=0.05)
        assert st.add("hb/w0", "x", replace=False, ttl=None) == {
            "ok": False, "error": "exists"}
        time.sleep(0.1)
        assert st.touch(["hb/w0"], ttl=60.0) == {"ok": True,
                                                 "missing": ["hb/w0"]}
        assert st.get("hb/w0") == {"ok": False, "error": "not_found"}


def test_malformed_requests_get_the_same_answers(servers):
    import socket

    answers = {}
    for name, addr in servers.items():
        host, port = addr.rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=5) as s:
            f = s.makefile("rwb")
            out = []
            for line in (b"not json\n", b'{"op": "nope"}\n',
                         b'{"op": "get"}\n', b'{"op": "ping"}\n',
                         b'{"op": "get", "name": "none/here"}\n'):
                f.write(line)
                f.flush()
                out.append(json.loads(f.readline()))
            answers[name] = [{k: (v.split(":")[0] if k == "error" else v)
                              for k, v in a.items()} for a in out]
    assert answers["port"] == answers["ref"]


def test_watch_names_fires_when_a_key_goes(servers):
    repo = _client("port", servers["ref"])
    fired = threading.Event()
    repo.add("watch/w0", "up", replace=True)
    repo.watch_names(["watch/w0"], fired.set, poll_frequency=0.05,
                     wait_timeout=5)
    time.sleep(0.2)
    assert not fired.is_set()
    repo.delete("watch/w0")
    assert fired.wait(5)
    repo.close()


def test_the_launcher_world_runs_over_the_port_tcp_server(tmp_path):
    """``python -m areal_tpu_torch.apps.main async-ppo`` on the CPU with
    ``AREAL_NAME_RESOLVE_RPC`` set: every process rendezvous through the
    port's TCP server (no ``name_resolve`` directory is written), the run
    ends with its two metrics lines, and the server holds what the run
    published."""
    from test_torch_launcher import _run_world, _world_overrides

    srv = pt_srv.NameResolveServer("127.0.0.1", 0)
    addr = srv.start()
    os.environ["AREAL_NAME_RESOLVE_RPC"] = addr
    try:
        rc, out = _run_world(tmp_path, _world_overrides(tmp_path, "rpc")
                             + ["gen.device=cpu"])
    finally:
        os.environ.pop("AREAL_NAME_RESOLVE_RPC")
    try:
        assert rc == 0, out[-4000:]
        logs = tmp_path / "root" / "logs" / "rpc" / "t0"
        assert len(open(logs / "metrics.jsonl").readlines()) == 2
        assert not (tmp_path / "root" / "name_resolve").exists()
        c = _client("port", addr)
        assert c.get("areal_tpu/rpc/t0/model_version/actor").startswith("2:")
        assert c.get("areal_tpu/rpc/t0/experiment_status") == "stopped"
        c.close()
    finally:
        srv.stop()
