"""Stable content hashing for fingerprints and cache keys."""

from __future__ import annotations

import hashlib
import json
from typing import Any


def _canonical(obj: Any) -> Any:
    """Make an object JSON-serialisable deterministically."""
    if isinstance(obj, dict):
        return {str(k): _canonical(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def stable_hash(payload: Any) -> str:
    """SHA-256 hex digest of a canonical-JSON rendering of ``payload``."""
    blob = json.dumps(_canonical(payload), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()
