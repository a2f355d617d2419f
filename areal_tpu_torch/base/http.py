"""JSON over HTTP/1.1 on the standard library, both ends.

- Server: ``start_server(routes, host, port)`` answers each request on a
  thread of its own (``ThreadingHTTPServer``). A route is a function of
  the raw body returning ``(status, payload)`` or ``(status, payload,
  headers)``; the payload goes out as JSON.
- Client: ``request_json`` is one request on a connection of its own over
  ``asyncio.open_connection``, so any number of calls can be in flight on
  one event loop without threads (what aiohttp gives the reference).
  Errors mirror aiohttp's: ``ClientConnectionError`` (refused, reset or
  closed before the answer; also a ``ConnectionError``) and
  ``ClientResponseError`` carrying ``status`` for a 4xx/5xx answer.
"""

import asyncio
import json
import logging
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger("areal_tpu_torch.http")

Route = Callable[[bytes], tuple]


class ClientError(Exception):
    pass


class ClientConnectionError(ClientError, ConnectionError):
    pass


class ClientResponseError(ClientError):
    def __init__(self, status: int, message: str = "",
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(f"{status}, message={message!r}")
        self.status = status
        self.message = message
        self.headers = headers or {}


# ---------------------------------------------------------------------- #
# server
# ---------------------------------------------------------------------- #


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a rollout fleet opens a connection per in-flight request: the
    # default backlog of 5 would drop SYNs under a burst of them
    request_queue_size = 1024

    def handle_error(self, request, client_address):
        """A client that went away before its answer (a rollout worker
        stopping at teardown) is logged at debug level; anything else with
        its traceback, through logging rather than on stderr."""
        err = sys.exc_info()[1]
        if isinstance(err, (BrokenPipeError, ConnectionResetError)):
            logger.debug("client %s went away: %r", client_address, err)
        else:
            logger.exception("error answering %s", client_address)


def make_handler(routes: Dict[Tuple[str, str], Route]):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _dispatch(self, method: str):
            fn = routes.get((method, self.path.split("?", 1)[0]))
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            headers = {}
            if fn is None:
                status, payload = 404, {"error": f"no route {method} {self.path}"}
            else:
                status, payload, *rest = fn(body)
                if rest:
                    headers = rest[0]
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def log_message(self, fmt, *args):
            logger.debug("%s - " + fmt, self.address_string(), *args)

    return Handler


def start_server(routes: Dict[Tuple[str, str], Route], host: str, port: int,
                 name: str) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Bind and serve ``routes`` on a daemon thread; ``httpd.shutdown()``
    and ``httpd.server_close()`` stop it."""
    httpd = _Server((host, port), make_handler(routes))
    t = threading.Thread(target=httpd.serve_forever, name=name, daemon=True)
    t.start()
    return httpd, t


def parse_json(body: bytes) -> dict:
    """A request body as a JSON object (ValueError otherwise)."""
    d = json.loads(body or b"{}")
    if not isinstance(d, dict):
        raise ValueError("body must be a JSON object")
    return d


# ---------------------------------------------------------------------- #
# client
# ---------------------------------------------------------------------- #


async def _exchange(method: str, url: str, body) -> Tuple[int, dict, bytes]:
    u = urllib.parse.urlsplit(url)
    host, port = u.hostname, u.port or 80
    path = (u.path or "/") + (f"?{u.query}" if u.query else "")
    data = b"" if body is None else json.dumps(body).encode()
    try:
        reader, writer = await asyncio.open_connection(host, port)
    except OSError as e:
        raise ClientConnectionError(f"cannot connect to {url}: {e!r}") from e
    try:
        writer.write(
            f"{method} {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n"
            .encode("latin-1") + data
        )
        await writer.drain()
        line = await reader.readline()
        if not line:
            raise ClientConnectionError(f"{url}: connection closed before "
                                        "the answer")
        status = int(line.split(b" ", 2)[1])
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = headers.get("content-length")
        payload = (await reader.readexactly(int(n)) if n is not None
                   else await reader.read())
    except (OSError, asyncio.IncompleteReadError) as e:
        raise ClientConnectionError(f"{url}: {e!r}") from e
    finally:
        writer.close()
    return status, headers, payload


async def request_json(method: str, url: str, body: Optional[dict] = None,
                       timeout: Optional[float] = None) -> dict:
    """One HTTP request; the answer's JSON. Raises ``ClientResponseError``
    for a status >= 400, ``ClientConnectionError`` when no answer came and
    ``asyncio.TimeoutError`` past ``timeout`` seconds."""
    status, headers, payload = await asyncio.wait_for(
        _exchange(method, url, body), timeout)
    if status >= 400:
        raise ClientResponseError(status, payload.decode("utf-8", "replace"),
                                  headers)
    return json.loads(payload) if payload else {}
