"""Structured logging helpers.

Parity reference: the zerolog usage pattern throughout the reference —
component-scoped loggers with key=value fields and stage duration logging
(e.g. shard.go:218,460; vamana.go:255). Plain stdlib logging underneath,
with a JSON mode matching zerolog's default output and a pretty mode
(main.go:21-36 debug/pretty switches).
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "level": record.levelname.lower(),
            "time": int(record.created),
            "component": record.name,
            "message": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out)


class PrettyFormatter(logging.Formatter):
    """Console mode: message followed by key=value fields (zerolog pretty)."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        extra = getattr(record, "fields", None)
        if extra:
            base += " " + " ".join(f"{k}={v}" for k, v in extra.items())
        return base


def setup_logging(debug: bool = False, pretty: bool = False) -> None:
    handler = logging.StreamHandler()
    if pretty:
        handler.setFormatter(
            PrettyFormatter("%(asctime)s %(levelname)-5s %(name)s %(message)s")
        )
    else:
        handler.setFormatter(JsonFormatter())
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(logging.DEBUG if debug else logging.INFO)


def get_logger(component: str) -> "FieldLogger":
    return FieldLogger(logging.getLogger(component))


class FieldLogger:
    """zerolog-style chained fields: log.with(shard=id).debug("msg")."""

    def __init__(self, logger: logging.Logger, fields: dict | None = None):
        self._logger = logger
        self._fields = fields or {}

    def with_fields(self, **fields) -> "FieldLogger":
        return FieldLogger(self._logger, {**self._fields, **fields})

    def _log(self, level: int, msg: str, **fields) -> None:
        self._logger.log(level, msg, extra={"fields": {**self._fields, **fields}})

    def debug(self, msg: str, **fields) -> None:
        self._log(logging.DEBUG, msg, **fields)

    def info(self, msg: str, **fields) -> None:
        self._log(logging.INFO, msg, **fields)

    def warn(self, msg: str, **fields) -> None:
        self._log(logging.WARNING, msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self._log(logging.ERROR, msg, **fields)

    def hbm(self, msg: str) -> None:
        """Debug-log device bytes_in_use (SEMADB_LOG_HBM=1 only — the
        stats call itself costs a device roundtrip)."""
        if not os.environ.get("SEMADB_LOG_HBM"):
            return
        try:
            import jax

            st = jax.local_devices()[0].memory_stats() or {}
            self.debug(
                msg,
                hbm_gb=round(st.get("bytes_in_use", 0) / 2**30, 2),
                peak_gb=round(st.get("peak_bytes_in_use", 0) / 2**30, 2),
            )
        except Exception:  # stats unsupported on some backends
            pass

    @contextmanager
    def timed(self, msg: str, level: int = logging.DEBUG, **fields):
        """Duration logging for a stage (the reference logs stage durations
        at debug level across the write/search paths).

        With SEMADB_TIMED_SYNC=1 a queue-drain barrier runs at entry and
        exit so the duration covers device EXECUTION, not just dispatch
        (the device stream executes in order, so blocking on a freshly
        dispatched op waits for everything queued before it). Profiling
        aid — the barrier itself costs a host↔device roundtrip, leave it
        off in production."""
        sync = bool(os.environ.get("SEMADB_TIMED_SYNC"))
        if sync:
            _queue_drain()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _queue_drain()
            self._log(
                level, msg, duration_ms=round((time.perf_counter() - t0) * 1e3, 2),
                **fields,
            )


def _queue_drain() -> None:
    """Wait for the default device's queued work (in-order stream)."""
    import jax

    jax.block_until_ready(jax.numpy.zeros((1,), jax.numpy.int32))
