"""Structured leveled logging (the reference's iLogger parity).

The reference logs through DE-labtory/iLogger with structured fields
(reference comm.go:82,92,95 — its only observability besides tests).
Here: stdlib logging with a per-node adapter that prefixes every line
with the validator id and renders keyword fields deterministically —
enough to correlate multi-node interleavings in one process.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_ROOT = "cleisthenes_tpu_torch"


def configure(level: int = logging.INFO, stream=None) -> None:
    """Install a handler on the framework's root logger (idempotent)."""
    logger = logging.getLogger(_ROOT)
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(h)


class NodeLogger:
    """Per-validator logger with structured key=value fields."""

    def __init__(self, node_id: Optional[str] = None, subsystem: str = ""):
        name = _ROOT
        if subsystem:
            name += f".{subsystem}"
        self._log = logging.getLogger(name)
        self._prefix = f"[{node_id}] " if node_id else ""

    def _fmt(self, msg: str, fields: dict) -> str:
        if not fields:
            return self._prefix + msg
        kv = " ".join(f"{k}={fields[k]!r}" for k in sorted(fields))
        return f"{self._prefix}{msg} {kv}"

    def debug(self, msg: str, **fields) -> None:
        self._log.debug(self._fmt(msg, fields))

    def info(self, msg: str, **fields) -> None:
        self._log.info(self._fmt(msg, fields))

    def warning(self, msg: str, **fields) -> None:
        self._log.warning(self._fmt(msg, fields))

    def error(self, msg: str, **fields) -> None:
        self._log.error(self._fmt(msg, fields))


__all__ = ["configure", "NodeLogger"]
