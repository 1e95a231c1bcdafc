"""Atomic artifact persistence: .npz arrays + manifest + sentinel.

Counterpart of ``vectordb_retrieval_tpu/models/persist.py`` with the same
on-disk format, so either package loads the other's artifacts:

  * ``arrays.npz`` holds the artifact's tensors under their ``/``-joined
    keys; bf16 tensors are stored as their raw 16 bits (``uint16``) under
    the key plus ``.bf16`` (npz has no bfloat16);
  * ``manifest.json`` carries schema_version / kind / metadata / array keys
    / dataset fingerprint / config hash, all validated on load (a mismatch
    raises ``ValueError``);
  * the ``WRITE_COMPLETE`` sentinel marks a finished write; the directory
    is written under a temporary name and moved into place.

bf16 goes through ``int16`` views of the raw bits, so no bfloat16 numpy
type (``ml_dtypes``) is needed.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.models.base import (
    BF16_SUFFIX,
    IndexArtifact,
    leaf_to_tensor,
)
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device

SCHEMA_VERSION = 1
SENTINEL = "WRITE_COMPLETE"
MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"


def _flatten(data: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, val in data.items():
        full = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(_flatten(val, prefix=full + "/"))
        elif val is None:
            continue
        elif isinstance(val, torch.Tensor) and val.dtype == torch.bfloat16:
            raw = val.detach().cpu().contiguous().view(torch.int16).numpy()
            flat[full + BF16_SUFFIX] = raw.view(np.uint16)
        elif isinstance(val, torch.Tensor):
            flat[full] = val.detach().cpu().numpy()
        else:
            flat[full] = np.asarray(val)
    return flat


def _unflatten(flat: Dict[str, np.ndarray], device: torch.device) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        key, tensor = leaf_to_tensor(key, val, device)
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = tensor
    return out


def save_artifact(
    artifact: IndexArtifact, path: str, context: Optional[Dict[str, Any]] = None
) -> None:
    """Atomically persist an artifact directory at ``path``."""
    context = context or {}
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".artifact_tmp_", dir=parent)
    try:
        arrays = _flatten(artifact.data)
        np.savez(os.path.join(tmp, ARRAYS), **arrays)
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "kind": artifact.kind,
            "metadata": artifact.metadata,
            "array_keys": sorted(arrays),
            "dataset_fingerprint": context.get("dataset_fingerprint"),
            "config_hash": context.get("config_hash"),
        }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2, default=str)
        with open(os.path.join(tmp, SENTINEL), "w") as f:
            f.write("ok\n")
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_artifact(
    path: str,
    context: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> IndexArtifact:
    """Load and validate a persisted artifact onto ``device`` (``None``: the
    CUDA card); raises on any integrity failure."""
    context = context or {}
    dev = resolve_device(device)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"artifact dir not found: {path}")
    if not os.path.exists(os.path.join(path, SENTINEL)):
        raise ValueError(f"artifact at {path} is incomplete (missing {SENTINEL})")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"artifact schema_version {manifest.get('schema_version')} "
            f"!= expected {SCHEMA_VERSION}"
        )
    for key in ("dataset_fingerprint", "config_hash"):
        want = context.get(key)
        have = manifest.get(key)
        if want is not None and have is not None and want != have:
            raise ValueError(
                f"artifact {key} mismatch: saved {have!r} != expected {want!r}"
            )
    expected_kind = context.get("kind")
    if expected_kind is not None and manifest["kind"] != expected_kind:
        raise ValueError(
            f"artifact kind {manifest['kind']!r} != expected {expected_kind!r}"
        )
    with np.load(os.path.join(path, ARRAYS)) as npz:
        flat = {k: npz[k] for k in npz.files}
    return IndexArtifact(
        kind=manifest["kind"],
        data=_unflatten(flat, dev),
        metadata=manifest.get("metadata", {}),
    )
