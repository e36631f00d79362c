"""Request ids (the two id helpers of
analytics_zoo_tpu/observability/request_log.py:89-97, copied).  The
per-request lifecycle log itself is not ported yet; the serving front
end uses these to key and echo `X-Request-Id`."""

from __future__ import annotations

import uuid


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def sanitize_request_id(rid: str) -> str:
    """Clamp a client-supplied id to something safe to echo in an HTTP
    header and store as a key: [A-Za-z0-9_.:-], max 64 chars."""
    cleaned = "".join(
        c if c.isalnum() or c in "_.:-" else "_" for c in str(rid))
    return cleaned[:64] or new_request_id()
