"""Leveled logger — the KIRK::Log analog.

Parity target: /root/reference/src/libraries/KIRK/Utils/Log.{h,cpp}
(LOG_DEBUG/INFO/WARN/ERROR with printf-style `%` substitution, colored
console + optional file sink, Log.h:26-53,84,103). Thin wrapper over
python logging so it composes with absl/jax logging.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_COLORS = {"DEBUG": "\033[37m", "INFO": "\033[32m", "WARNING": "\033[33m",
           "ERROR": "\033[31m"}
_RESET = "\033[0m"

_logger: Optional[logging.Logger] = None


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        base = super().format(record)
        if sys.stderr.isatty():
            return _COLORS.get(record.levelname, "") + base + _RESET
        return base


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        _logger = logging.getLogger("ba_pathtracing_fur")
        _logger.setLevel(logging.INFO)
        hdl = logging.StreamHandler(sys.stderr)
        hdl.setFormatter(_ColorFormatter("[%(levelname).1s] %(message)s"))
        _logger.addHandler(hdl)
        _logger.propagate = False
    return _logger


def init_log_file(prefix: str) -> None:
    """Log::initLogFile analog (Log.h:84): adds a file sink."""
    hdl = logging.FileHandler(f"{prefix}.log")
    hdl.setFormatter(logging.Formatter("[%(levelname).1s %(asctime)s] %(message)s"))
    get_logger().addHandler(hdl)


def set_level(level: str) -> None:
    get_logger().setLevel(getattr(logging, level.upper()))


def _subst(fmt: str, *args) -> str:
    """The reference's `%` placeholder substitution (Log.h:103)."""
    out = []
    ai = 0
    for chcount, ch in enumerate(fmt):
        if ch == "%" and ai < len(args):
            out.append(str(args[ai]))
            ai += 1
        else:
            out.append(ch)
    return "".join(out)


def log_debug(fmt: str, *args) -> None:
    get_logger().debug(_subst(fmt, *args))


def log_info(fmt: str, *args) -> None:
    get_logger().info(_subst(fmt, *args))


def log_warn(fmt: str, *args) -> None:
    get_logger().warning(_subst(fmt, *args))


def log_error(fmt: str, *args) -> None:
    get_logger().error(_subst(fmt, *args))
