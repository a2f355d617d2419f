"""Port allocation and host identity (the slice's subset of
``areal_tpu/base/network.py``)."""

import socket


def gethostip() -> str:
    """This host's address as its own resolver gives it (no packet leaves
    the host)."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def find_free_port() -> int:
    """A free TCP port, from the kernel's bind-0 choice."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        return s.getsockname()[1]
