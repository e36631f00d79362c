"""Cross-process trace context propagation, W3C-traceparent style (a
copy of analytics_zoo_tpu/observability/trace_context.py).

A :class:`TraceContext` is the wire form of a span: ``(trace_id,
span_id, flags)``.  It rides next to the existing ``X-Request-Id``
machinery on every hop a request takes through the fleet:

* HTTP — the ``traceparent`` request/response header
  (:func:`inject_headers` / :func:`extract_headers`),
* record documents — a ``"traceparent"`` envelope field on the
  document (:func:`inject_record` / :func:`extract_record`; the
  serving client stamps it on an ``/enqueue`` body),
* child processes — the ``TRACEPARENT`` environment variable
  (:func:`inject_env` / :func:`from_env`, and :func:`env_bound` for
  spawn factories that inherit ``os.environ``).

The header value is the W3C format ``00-<trace_id>-<span_id>-<flags>``.
Native ids are the 16-hex ids minted by :mod:`.tracing`; the parser
also accepts 32-hex trace ids from external W3C producers.

A received context becomes the *ambient remote parent* via
:func:`bind`; :func:`analytics_zoo_tpu_torch.observability.tracing.trace`
consults it when no local span is open, so the first span opened after
``bind`` joins the remote trace with no explicit ``parent=`` plumbing.
Processes launched with ``TRACEPARENT`` in their environment join the
trace automatically: :func:`remote_parent` falls back to the environment
the first time it is consulted.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
from typing import Any, Dict, Mapping, Optional

__all__ = [
    "TRACEPARENT_HEADER",
    "TRACEPARENT_ENV",
    "RECORD_FIELD",
    "TraceContext",
    "parse_traceparent",
    "format_traceparent",
    "bind",
    "remote_parent",
    "current_trace_context",
    "inject_headers",
    "extract_headers",
    "inject_env",
    "from_env",
    "env_bound",
    "install_from_env",
    "inject_record",
    "extract_record",
]

TRACEPARENT_HEADER = "traceparent"
TRACEPARENT_ENV = "TRACEPARENT"
#: Envelope field carried on stream-record documents.
RECORD_FIELD = "traceparent"

_HEX = re.compile(r"^[0-9a-f]+$")


class TraceContext:
    """Immutable ``(trace_id, span_id, flags)`` triple.

    Exposes ``trace_id`` / ``span_id`` attributes so it duck-types as a
    ``parent=`` for :func:`~analytics_zoo_tpu_torch.observability.tracing.trace`.
    """

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: int = 1) -> None:
        object.__setattr__(self, "trace_id", str(trace_id))
        object.__setattr__(self, "span_id", str(span_id))
        object.__setattr__(self, "flags", int(flags) & 0xFF)

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("TraceContext is immutable")

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags:02x}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "flags": self.flags,
        }

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, TraceContext)
            and other.trace_id == self.trace_id
            and other.span_id == self.span_id
            and other.flags == self.flags
        )

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id, self.flags))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.traceparent()!r})"


def format_traceparent(ctx: "TraceContext") -> str:
    return ctx.traceparent()


def parse_traceparent(value: Any) -> Optional[TraceContext]:
    """Parse a traceparent string; returns ``None`` on anything malformed.

    Never raises — a bad header from a foreign client must not take the
    request down with it.
    """
    if not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or not _HEX.match(version) or version == "ff":
        return None
    if len(trace_id) not in (16, 32) or not _HEX.match(trace_id):
        return None
    if len(span_id) != 16 or not _HEX.match(span_id):
        return None
    if len(flags) != 2 or not _HEX.match(flags):
        return None
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None
    return TraceContext(trace_id, span_id, int(flags, 16))


# --------------------------------------------------------------------------
# Ambient remote parent
# --------------------------------------------------------------------------

_REMOTE: "contextvars.ContextVar[Optional[TraceContext]]" = contextvars.ContextVar(
    "azt_remote_trace_context", default=None
)
# Process-wide default, installed once from the TRACEPARENT env var so
# spawned children join their parent's trace with zero wiring.
_PROCESS_DEFAULT: Optional[TraceContext] = None
_ENV_CHECKED = False


def install_from_env(environ: Optional[Mapping[str, str]] = None) -> Optional[TraceContext]:
    """Adopt ``TRACEPARENT`` from the environment as the process default."""
    global _PROCESS_DEFAULT, _ENV_CHECKED
    _ENV_CHECKED = True
    ctx = from_env(environ)
    if ctx is not None:
        _PROCESS_DEFAULT = ctx
    return ctx


def remote_parent() -> Optional[TraceContext]:
    """The ambient remote parent, if any.

    Order: explicit :func:`bind` in this execution context, then the
    process default inherited via the ``TRACEPARENT`` env var.
    """
    ctx = _REMOTE.get()
    if ctx is not None:
        return ctx
    global _ENV_CHECKED
    if not _ENV_CHECKED:
        install_from_env()
    return _PROCESS_DEFAULT


@contextlib.contextmanager
def bind(ctx: Optional[TraceContext]):
    """Bind ``ctx`` as the ambient remote parent for this context.

    ``bind(None)`` is a no-op context manager, so call sites can pass
    whatever :func:`extract_headers` / :func:`extract_record` returned
    without branching.
    """
    if ctx is None:
        yield None
        return
    token = _REMOTE.set(ctx)
    try:
        yield ctx
    finally:
        _REMOTE.reset(token)


def current_trace_context() -> Optional[TraceContext]:
    """The context to propagate downstream from *here*.

    The innermost open local span wins (its ``span_id`` becomes the
    downstream parent); otherwise the ambient remote parent is passed
    through unchanged.
    """
    from analytics_zoo_tpu_torch.observability.tracing import current_span

    sp = current_span()
    if sp is not None:
        return TraceContext(sp.trace_id, sp.span_id)
    return remote_parent()


# --------------------------------------------------------------------------
# Carriers
# --------------------------------------------------------------------------


def inject_headers(
    headers: Dict[str, str], ctx: Optional[TraceContext] = None
) -> Dict[str, str]:
    """Add a ``traceparent`` header (mutates and returns ``headers``)."""
    ctx = ctx if ctx is not None else current_trace_context()
    if ctx is not None:
        headers[TRACEPARENT_HEADER] = ctx.traceparent()
    return headers


def extract_headers(headers: Any) -> Optional[TraceContext]:
    """Parse ``traceparent`` out of any mapping-like with ``.get``."""
    if headers is None:
        return None
    try:
        value = headers.get(TRACEPARENT_HEADER) or headers.get(
            TRACEPARENT_HEADER.title()
        )
    except Exception:
        return None
    return parse_traceparent(value)


def inject_env(
    env: Dict[str, str], ctx: Optional[TraceContext] = None
) -> Dict[str, str]:
    """Add ``TRACEPARENT`` to an environment dict for a child process."""
    ctx = ctx if ctx is not None else current_trace_context()
    if ctx is not None:
        env[TRACEPARENT_ENV] = ctx.traceparent()
    return env


def from_env(environ: Optional[Mapping[str, str]] = None) -> Optional[TraceContext]:
    environ = os.environ if environ is None else environ
    return parse_traceparent(environ.get(TRACEPARENT_ENV))


@contextlib.contextmanager
def env_bound(ctx: Optional[TraceContext] = None):
    """Temporarily export the current context into ``os.environ``.

    For spawn factories (elastic members, dryrun children) that build the
    child environment from ``os.environ``: children started inside this
    block inherit ``TRACEPARENT`` and join the trace automatically.
    """
    ctx = ctx if ctx is not None else current_trace_context()
    if ctx is None:
        yield None
        return
    prev = os.environ.get(TRACEPARENT_ENV)
    os.environ[TRACEPARENT_ENV] = ctx.traceparent()
    try:
        yield ctx
    finally:
        if prev is None:
            os.environ.pop(TRACEPARENT_ENV, None)
        else:
            os.environ[TRACEPARENT_ENV] = prev


def inject_record(doc: Any, ctx: Optional[TraceContext] = None) -> Any:
    """Stamp the envelope field onto a stream-record document.

    No-op unless ``doc`` is a dict without an existing ``traceparent``
    and a context is available.  Returns ``doc``.
    """
    if not isinstance(doc, dict) or RECORD_FIELD in doc:
        return doc
    ctx = ctx if ctx is not None else current_trace_context()
    if ctx is not None:
        doc[RECORD_FIELD] = ctx.traceparent()
    return doc


def extract_record(doc: Any) -> Optional[TraceContext]:
    if not isinstance(doc, dict):
        return None
    return parse_traceparent(doc.get(RECORD_FIELD))
