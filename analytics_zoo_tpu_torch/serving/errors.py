"""The serving errors the generation engine raises (a copy of the
JAX package's `serving/errors.py` subset this port needs)."""

from __future__ import annotations


class QueueFull(RuntimeError):
    """Admission shed: the waiting queue is at its bound (HTTP 503).
    Carries the server's backoff hint ``retry_after_s`` (seconds)."""

    def __init__(self, message: str,
                 retry_after_s: "float | None" = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RequestTooLarge(ValueError):
    """The request can never fit this engine's geometry (prompt +
    max_new_tokens vs max_context or the whole block pool) — a client
    error (HTTP 413); retrying unchanged cannot succeed."""


__all__ = ["QueueFull", "RequestTooLarge"]
