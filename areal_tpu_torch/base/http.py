"""JSON over HTTP/1.1 on the standard library, both ends.

- Server: ``start_server(routes, host, port)`` answers each request on a
  thread of its own (``ThreadingHTTPServer``). A route is a function of
  the raw body returning ``(status, payload)`` or ``(status, payload,
  headers)``; the payload goes out as JSON, or, when it is a ``Stream``,
  frame by frame until the stream ends, on a connection closed after it.
- Client: ``request_json`` is one request on a connection of its own over
  ``asyncio.open_connection``, so any number of calls can be in flight on
  one event loop without threads (what aiohttp gives the reference);
  ``open_stream`` opens a streamed answer and reads it line by line.
  Errors mirror aiohttp's: ``ClientConnectionError`` (refused, reset or
  closed before the answer; also a ``ConnectionError``) and
  ``ClientResponseError`` carrying ``status`` for a 4xx/5xx answer.
"""

import asyncio
import json
import logging
import select
import socket
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterator, Optional, Tuple

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


class Stream:
    """A streamed answer (server-sent events): each item of ``frames``
    (bytes) is written and flushed as it comes, and the connection closes
    after the last. Before
    each write the server checks that the client is still there; once it
    has gone (its end closed, or a write failed) no more frames are taken.
    Either way ``close()`` runs at the end: it closes ``frames`` and calls
    ``on_close``, which can release what the stream held."""

    def __init__(self, frames: Iterator[bytes],
                 on_close: Optional[Callable[[], None]] = None):
        self.frames = frames
        self.on_close = on_close

    def close(self):
        close = getattr(self.frames, "close", None)
        try:
            if close is not None:
                close()
        finally:
            if self.on_close is not None:
                self.on_close()


def peer_closed(sock: socket.socket) -> bool:
    """Whether the other end of ``sock`` has closed it (readable, and a
    peek reads end of file). A client sends its whole request before it
    reads the answer, so nothing else makes the socket readable."""
    try:
        readable, _, _ = select.select([sock], [], [], 0)
        if not readable:
            return False
        return sock.recv(1, socket.MSG_PEEK) == b""
    except (BlockingIOError, InterruptedError):
        return False
    except (OSError, ValueError):
        return True


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
            if isinstance(payload, Stream):
                self._stream(status, payload, headers)
                return
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _stream(self, status: int, stream: Stream, headers: dict):
            self.close_connection = True
            try:
                self.send_response(status)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                for k, v in headers.items():
                    self.send_header(k, v)
                self.end_headers()
                for frame in stream.frames:
                    if peer_closed(self.connection):
                        raise ConnectionResetError("the client went away")
                    self.wfile.write(frame)
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError,
                    ConnectionAbortedError) as e:
                logger.debug("stream to %s ended: %r", self.client_address, e)
            finally:
                stream.close()

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


async def _open(method: str, url: str, body):
    """Connect, send the request and read the answer's status line and
    headers: ``(reader, writer, status, headers)``. On an error the
    connection is closed before it raises."""
    u = urllib.parse.urlsplit(url)
    host, port = u.hostname, u.port or 80
    path = (u.path or "/") + (f"?{u.query}" if u.query else "")
    data = b"" if body is None else json.dumps(body).encode()
    try:
        # a streamed answer's line (one SSE frame) may outgrow the default
        # 64 KiB line limit
        reader, writer = await asyncio.open_connection(host, port,
                                                       limit=1 << 22)
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
    except (OSError, asyncio.IncompleteReadError) as e:
        writer.close()
        raise ClientConnectionError(f"{url}: {e!r}") from e
    except BaseException:
        writer.close()
        raise
    return reader, writer, status, headers


async def _read_payload(reader, headers: dict) -> bytes:
    n = headers.get("content-length")
    return (await reader.readexactly(int(n)) if n is not None
            else await reader.read())


async def _exchange(method: str, url: str, body) -> Tuple[int, dict, bytes]:
    reader, writer, status, headers = await _open(method, url, body)
    try:
        payload = await _read_payload(reader, headers)
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


class StreamResponse:
    """An open streamed answer (``open_stream``): ``readline()`` returns
    its next line, ``b""`` once the server has closed the connection;
    ``close()`` closes it from this end."""

    def __init__(self, url: str, reader, writer, headers: dict):
        self.url = url
        self.headers = headers
        self._reader = reader
        self._writer = writer

    async def readline(self) -> bytes:
        try:
            return await self._reader.readline()
        except (OSError, asyncio.IncompleteReadError, ValueError) as e:
            raise ClientConnectionError(f"{self.url}: {e!r}") from e

    def close(self):
        self._writer.close()


async def open_stream(method: str, url: str, body: Optional[dict] = None,
                      timeout: Optional[float] = None) -> StreamResponse:
    """Send one request and wait for its answer's headers (at most
    ``timeout`` seconds). A status >= 400 reads the body and raises
    ``ClientResponseError``; otherwise the answer's body is left to read
    line by line from the returned ``StreamResponse``."""
    reader, writer, status, headers = await asyncio.wait_for(
        _open(method, url, body), timeout)
    if status >= 400:
        try:
            payload = await asyncio.wait_for(
                _read_payload(reader, headers), timeout)
        except (OSError, asyncio.IncompleteReadError) as e:
            raise ClientConnectionError(f"{url}: {e!r}") from e
        finally:
            writer.close()
        raise ClientResponseError(status, payload.decode("utf-8", "replace"),
                                  headers)
    return StreamResponse(url, reader, writer, headers)
