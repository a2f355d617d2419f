"""Logger factory (the counterpart of ``areal_tpu/base/logging.py``): one
stdout handler in the reference's format on the port's root logger, and
per-module children. ``AREAL_LOG_LEVEL`` sets the level.
"""

import logging
import sys
from typing import Optional

from areal_tpu_torch.base import constants

_FORMAT = "%(asctime)s.%(msecs)03d %(name)s %(levelname)s: %(message)s"
_DATE_FORMAT = "%Y%m%d-%H:%M:%S"

ROOT = "areal_torch"

_configured = False


def _configure_root():
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT, _DATE_FORMAT))
    root = logging.getLogger(ROOT)
    root.setLevel(constants.log_level())
    root.addHandler(handler)
    root.propagate = False
    _configured = True


def getLogger(name: Optional[str] = None) -> logging.Logger:
    _configure_root()
    if not name:
        return logging.getLogger(ROOT)
    return logging.getLogger(f"{ROOT}.{name}")
