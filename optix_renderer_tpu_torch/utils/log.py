"""Structured logging (replaces the reference's LOG/LOG_OK printf macros,
include/common.h:7-14, with stdlib logging + the same green/ok coloring)."""

from __future__ import annotations

import logging
import os
import sys

_GREEN = "\033[32m"
_BOLD_GREEN = "\033[1;32m"
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if not sys.stderr.isatty() or os.environ.get("NO_COLOR"):
            return msg
        if record.levelno >= logging.WARNING:
            return msg
        if getattr(record, "ok", False):
            return f"{_BOLD_GREEN}{msg}{_RESET}"
        return f"{_GREEN}{msg}{_RESET}"


def get_logger(name: str = "optix_renderer_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(_ColorFormatter("[%(name)s] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("OPTIX_TPU_LOGLEVEL", "INFO").upper())
        logger.propagate = False
    return logger


def log_ok(logger: logging.Logger, msg: str, *args) -> None:
    """LOG_OK equivalent (bold green)."""
    logger.info(msg, *args, extra={"ok": True})
