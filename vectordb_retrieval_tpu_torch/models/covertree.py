"""CoverTree: exact k-NN cover tree (the reference's ``CoverTreeV2_2``).

Counterpart of ``vectordb_retrieval_tpu/models/covertree.py`` with the same
build, layout, knobs, artifact (kind ``covertree``, schema ``covertree_v4``)
and persistence checks, so either package loads the other's index.

Build: points are inserted in seeded random order, 4,096 at a time; each
attaches to the deepest already-placed node whose cover ball contains it,
found by one chunked distance scan over the placed prefix on the device
(:func:`_deepest_cover_batch`). Then, on the host in NumPy:
:func:`cap_fanout` groups oversized child lists under virtual nodes,
:func:`exact_subtree_radii` replaces the analytic ``2^(level+1)`` bounds
with exact bottom-up radii (f64, rounded up to f32), and
:func:`depth_slab_layout` stores the tree depth-major, block-aligned.

Search (``ops/covertree.py``): ``descent="auto"`` takes the block walk,
whose stage 1 is kernel K1 in bf16 mode, where the artifact lies on the
card, and the per-node stream walk on the CPU; ``blockwalk`` and ``stream``
are honoured on either device. Queries whose certificate fails fall back to
exact search (only those rows), so results are always exact.

Cosine: vectors are L2-normalised and the tree is built in Euclidean space;
searches return ``-cos`` (= ``d^2 / 2 - 1``).
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.models import persist
from vectordb_retrieval_tpu_torch.models.base import BaseAlgorithm, IndexArtifact, host_search
from vectordb_retrieval_tpu_torch.ops import covertree as ctops
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike, resolve_device

_MIN_LEVEL = -40  # 2^-40 ~ duplicate points
_BUILD_BATCH = 4096
_SCORE_LEVEL_SCALE = 1e6  # deepest-cover selection: level dominates distance
_SCAN_CHUNK = 65_536
SCHEMA = "covertree_v4"


def _deepest_cover_batch(
    batch_x: torch.Tensor,  # [B, d] points to insert
    x_ordered: torch.Tensor,  # [N, d] all points in insertion order
    levels_ordered: torch.Tensor,  # [N] int32 (entries >= n_placed ignored)
    n_placed: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each batch point, the deepest (lowest-level) placed node whose
    cover ball contains it: ``(slot in insertion order, distance)``.

    A chunked scan over the placed prefix scores ``level * 1e6 + distance``
    on covering nodes; the first minimum wins, as ``jnp.argmin`` does, and a
    point that no node covers gets slot -1. Unplaced rows could never win,
    so unlike the JAX package's fixed-shape scan this one stops at the
    prefix.
    """
    b = batch_x.shape[0]
    dev = batch_x.device
    best_s = torch.full((b,), float("inf"), device=dev)
    best_i = torch.full((b,), -1, dtype=torch.int64, device=dev)
    best_d = torch.full((b,), float("inf"), device=dev)
    for c0 in range(0, n_placed, _SCAN_CHUNK):
        c1 = min(c0 + _SCAN_CHUNK, n_placed)
        d2 = dops.pairwise_distances(batch_x, x_ordered[c0:c1], "l2")
        dist = torch.sqrt(torch.clamp(d2, min=0.0))
        lc = levels_ordered[c0:c1].float()[None, :]
        cover = dist <= torch.exp2(lc)
        score = torch.where(
            cover,
            lc * _SCORE_LEVEL_SCALE + torch.clamp(dist, max=_SCORE_LEVEL_SCALE - 1.0),
            torch.full_like(dist, float("inf")),
        )
        loc = torch.argmin(score, dim=1)  # first minimum
        loc_s = torch.gather(score, 1, loc[:, None])[:, 0]
        loc_d = torch.gather(dist, 1, loc[:, None])[:, 0]
        better = loc_s < best_s
        best_s = torch.where(better, loc_s, best_s)
        best_i = torch.where(better, loc + c0, best_i)
        best_d = torch.where(better, loc_d, best_d)
    return best_i, best_d


def build_cover_tree(
    x: np.ndarray,
    seed: int = 0,
    batch: int = _BUILD_BATCH,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, list, int]:
    """Batched build: ``(levels [N] int32, children lists, root)``, the
    JAX package's ``build_cover_tree`` with its distance scans on ``device``.

    Invariant: every child c of parent p has ``d(p, c) <= 2^level(p)`` and
    ``level(c) < level(p)``, up to the scan's rounding, which
    :func:`exact_subtree_radii` makes harmless. Points of one batch attach
    only to nodes placed before it (they become siblings). The root's
    level covers the whole dataset.
    """
    n = x.shape[0]
    if n == 0:
        raise ValueError("empty dataset")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n).astype(np.int64)
    root = int(order[0])
    xs = x.astype(np.float32)
    x_ordered = torch.as_tensor(xs[order], device=dev)

    d_root = np.sqrt(np.maximum(((xs - xs[root]) ** 2).sum(axis=1), 0.0))
    max_d = float(d_root.max())
    levels = np.zeros(n, dtype=np.int32)  # indexed by insertion slot
    levels[0] = max(int(math.ceil(math.log2(max(max_d, 1e-12)))), _MIN_LEVEL + 1)
    children: list = [[] for _ in range(n)]

    n_placed = 1
    while n_placed < n:
        end = min(n_placed + batch, n)
        batch_slots = np.arange(n_placed, end)
        slot, dist = _deepest_cover_batch(
            x_ordered[n_placed:end], x_ordered,
            torch.as_tensor(levels, device=dev), n_placed,
        )
        slot = slot.cpu().numpy()
        dist = dist.cpu().numpy()
        parent_level = levels[slot]
        with np.errstate(divide="ignore"):
            dist_level = np.floor(np.log2(np.maximum(dist, 1e-30))).astype(np.int64)
        child_level = np.minimum(parent_level - 1, dist_level)
        levels[batch_slots] = np.maximum(child_level, _MIN_LEVEL).astype(np.int32)
        for s, q in zip(batch_slots, slot):
            children[int(q)].append(int(s))
        n_placed = end

    # insertion slots back to dataset row ids
    levels_by_row = np.empty(n, dtype=np.int32)
    levels_by_row[order] = levels
    children_by_row: list = [[] for _ in range(n)]
    for slot_idx, kids in enumerate(children):
        if kids:
            children_by_row[int(order[slot_idx])] = [int(order[k]) for k in kids]
    return levels_by_row, children_by_row, root


def cap_fanout(xs: np.ndarray, levels: np.ndarray, children: list, cap: int = 64):
    """Bound node fanout by grouping oversized child lists under *virtual*
    nodes. A virtual node reuses a member point as its centre, covers its
    group within ``max(d(centre, c) + radius(c))`` and is not real (it never
    enters a top-k), so exactness is kept.

    Returns ``(point_ids [M] int32, radii [M] f32, is_real [M] bool, kids)``.
    """
    n = xs.shape[0]
    point_ids = list(range(n))
    radii = [float(np.exp2(float(lv) + 1.0)) for lv in levels]
    is_real = [True] * n
    kids = [list(c) for c in children]

    for node in range(n):
        while len(kids[node]) > cap:
            cur = kids[node]
            # locality: order children by distance to the parent point
            pts = np.asarray([point_ids[c] for c in cur])
            diff = xs[pts] - xs[point_ids[node]]
            order = np.argsort(np.einsum("ij,ij->i", diff, diff))
            cur = [cur[int(j)] for j in order]
            grouped = []
            for start in range(0, len(cur), cap):
                group = cur[start : start + cap]
                if len(group) == 1:
                    grouped.append(group[0])
                    continue
                center_pt = point_ids[group[0]]
                gpts = np.asarray([point_ids[c] for c in group])
                gdiff = xs[gpts] - xs[center_pt]
                gd = np.sqrt(np.einsum("ij,ij->i", gdiff, gdiff))
                grad = float(max(gd[j] + radii[group[j]] for j in range(len(group))))
                vid = len(point_ids)
                point_ids.append(center_pt)
                radii.append(grad)
                is_real.append(False)
                kids.append(group)
                grouped.append(vid)
            kids[node] = grouped
    return (
        np.asarray(point_ids, dtype=np.int32),
        np.asarray(radii, dtype=np.float32),
        np.asarray(is_real, dtype=bool),
        kids,
    )


def node_depths(kids: list, root: int) -> np.ndarray:
    """BFS depth of every node (root = 0); -1 for unreachable nodes."""
    m = len(kids)
    depth = np.full(m, -1, np.int64)
    depth[root] = 0
    frontier = [root]
    while frontier:
        nxt: list = []
        for v in frontier:
            dv = depth[v] + 1
            for c in kids[v]:
                depth[c] = dv
                nxt.append(c)
        frontier = nxt
    return depth


def exact_subtree_radii(
    xs: np.ndarray, point_ids: np.ndarray, kids: list, root: int
) -> np.ndarray:
    """Exact bottom-up subtree cover radii ``r(v) = max_c d(v, c) + r(c)``,
    in f64 difference form and rounded up to f32, so the stored radius
    covers the subtree however the build's rounding placed its nodes."""
    m = len(kids)
    depth = node_depths(kids, root)
    radii = np.zeros(m, np.float64)
    pid = np.asarray(point_ids, np.int64)
    xs64 = xs.astype(np.float64)
    # parent -> child edges, one depth at a time (deepest first)
    par = np.concatenate(
        [np.full(len(c), v, np.int64) for v, c in enumerate(kids) if c]
        or [np.empty(0, np.int64)]
    )
    chd = np.concatenate(
        [np.asarray(c, np.int64) for c in kids if c] or [np.empty(0, np.int64)]
    )
    if par.size:
        pdep = depth[par]
        for lvl in range(int(pdep.max()), -1, -1):
            sel = pdep == lvl
            if not sel.any():
                continue
            p, c = par[sel], chd[sel]
            diff = xs64[pid[c]] - xs64[pid[p]]
            d = np.sqrt(np.einsum("ij,ij->i", diff, diff))
            np.maximum.at(radii, p, d + radii[c])
    out = radii.astype(np.float32)
    bump = out < radii  # round up so the f32 value still covers the f64 bound
    out[bump] = np.nextafter(out[bump], np.float32(np.inf))
    return out


def depth_slab_layout(
    xs: np.ndarray,
    point_ids: np.ndarray,
    radii: np.ndarray,
    is_real: np.ndarray,
    kids: list,
    root: int,
    align: int = ctops.SLAB_ALIGN,
):
    """Reorder the tree depth-major: every BFS depth one contiguous block,
    padded to a multiple of ``align`` with inert rows (zero vector, not
    real, radius -1), each node with its parent's position within the
    parent's depth block.

    Returns ``(slab [M, d] f32, point_id [M] int32, radius [M] f32,
    is_real [M] bool, parent_rel [M] int32, row_pos [N] int32,
    depth_sizes)``, ``depth_sizes`` the padded widths.
    """
    m = len(kids)
    depth = node_depths(kids, root)
    order = np.argsort(depth, kind="stable")  # depth-major, real nodes only
    depth_sizes = np.bincount(depth[depth >= 0]).astype(np.int64)
    padded_sizes = ((depth_sizes + align - 1) // align) * align
    starts_real = np.concatenate([[0], np.cumsum(depth_sizes)])
    starts_pad = np.concatenate([[0], np.cumsum(padded_sizes)])
    m_pad = int(padded_sizes.sum())

    # slab position: rank within the depth block + the block's padded start
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m)
    slabpos = starts_pad[depth] + (rank - starts_real[depth])

    parent = np.full(m, -1, np.int64)
    for v, c in enumerate(kids):
        if c:
            parent[np.asarray(c, np.int64)] = v
    nonroot = parent >= 0

    dim = xs.shape[1]
    pid_arr = np.zeros(m_pad, np.int64)
    rad_arr = np.full(m_pad, -1.0, np.float32)  # <0 marks padding rows
    real_arr = np.zeros(m_pad, bool)
    prel_arr = np.zeros(m_pad, np.int64)
    slab = np.zeros((m_pad, dim), np.float32)

    pid = np.asarray(point_ids, np.int64)
    pid_arr[slabpos] = pid
    rad_arr[slabpos] = np.asarray(radii, np.float32)
    real_arr[slabpos] = np.asarray(is_real, bool)
    prel_arr[slabpos[nonroot]] = (
        slabpos[parent[nonroot]] - starts_pad[depth[parent[nonroot]]]
    )
    slab[slabpos] = xs[pid]

    n = xs.shape[0]
    row_pos = np.empty(n, np.int64)
    real_nodes = np.asarray(is_real, bool)
    row_pos[pid[real_nodes]] = slabpos[real_nodes]
    return (
        slab,
        pid_arr.astype(np.int32),
        rad_arr,
        real_arr,
        prel_arr.astype(np.int32),
        row_pos.astype(np.int32),
        tuple(int(s) for s in padded_sizes),
    )


class CoverTree(BaseAlgorithm):
    """Exact k-NN cover tree (reference ``CoverTreeV2_2`` equivalent)."""

    def __init__(
        self,
        dimension: int,
        metric: str = "l2",
        seed: int = 0,
        max_fanout: int = 64,
        kprime: int = 0,  # kth-bound fold width; 0 -> max(2k, k+256)
        err_c: float = ctops.DEFAULT_ERR_C,
        descent: str = "auto",  # auto | blockwalk | stream
        device: DeviceLike = None,
        **params: Any,
    ):
        super().__init__(dimension=dimension, metric=metric, **params)
        self.name = "CoverTree"
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.max_fanout = int(max_fanout)
        self.kprime = int(kprime)
        self.err_c = float(err_c)
        if descent not in ("auto", "blockwalk", "stream"):
            raise ValueError(f"unknown descent {descent!r}")
        self.descent = descent
        self._ndis_per_query = 0.0
        self.artifact: Optional[IndexArtifact] = None
        # seconds of the last build by part
        self.build_seconds: Dict[str, float] = {}
        # tensors derived from the artifact, made once per artifact
        self._derived: Dict[str, Any] = {}
        self._derived_of: Optional[IndexArtifact] = None

    # -- build ----------------------------------------------------------
    def build_index(self, vectors: np.ndarray) -> None:
        x = np.ascontiguousarray(vectors, dtype=np.float32)
        if self.metric == "cosine":
            norms = np.linalg.norm(x, axis=1, keepdims=True)
            x = x / np.maximum(norms, 1e-12)
        t0 = time.perf_counter()
        levels, child_lists, root = build_cover_tree(x, seed=self.seed, device=self.device)
        t1 = time.perf_counter()
        point_ids, radii, is_real, kids = cap_fanout(x, levels, child_lists, cap=self.max_fanout)
        t2 = time.perf_counter()
        radii = exact_subtree_radii(x, point_ids, kids, root)
        t3 = time.perf_counter()
        slab, pid, rad, real, prel, row_pos, depth_sizes = depth_slab_layout(
            x, point_ids, radii, is_real, kids, root
        )
        dev = self.device
        data = {
            "slab": torch.as_tensor(slab, device=dev),
            "point_ids": torch.as_tensor(pid, device=dev),
            "is_real": torch.as_tensor(real, device=dev),
            "radii": torch.as_tensor(rad, device=dev),
            "parent_rel": torch.as_tensor(prel, device=dev),
            "row_pos": torch.as_tensor(row_pos, device=dev),
        }
        t4 = time.perf_counter()
        self.build_seconds = {
            "insert_scans": t1 - t0, "cap_fanout": t2 - t1,
            "exact_subtree_radii": t3 - t2, "layout": t4 - t3,
        }
        self.artifact = IndexArtifact(
            "covertree",
            data,
            {
                "metric": self.metric,
                "dimension": int(x.shape[1]),
                "n_vectors": int(x.shape[0]),
                "n_nodes": int(len(pid)),
                "depth_sizes": [int(s) for s in depth_sizes],
                "algorithm": "CoverTree",
                "schema": SCHEMA,
            },
        )
        self.is_built = True

    # -- search ---------------------------------------------------------
    def uses_blockwalk(self) -> bool:
        """'auto' takes the block walk where the artifact lies on the card
        (K1 is native there) and the stream walk on the CPU."""
        if self.descent == "auto":
            return self.artifact.data["slab"].device.type == "cuda"
        return self.descent == "blockwalk"

    def _derive(self, key: str, make) -> Any:
        if self._derived_of is not self.artifact:
            self._derived, self._derived_of = {}, self.artifact
        if key not in self._derived:
            self._derived[key] = make()
        return self._derived[key]

    def blockwalk_prep(self) -> ctops.BlockWalkPrep:
        """The block walk's derived tensors, once per artifact."""
        d = self.artifact.data
        return self._derive("prep", lambda: ctops.blockwalk_prep(
            d["slab"], d["is_real"], d["radii"], d["parent_rel"],
            tuple(self.artifact.metadata["depth_sizes"]),
        ))

    def _kprime(self, eff_k: int, n: int) -> int:
        # fold width of the running kth upper bound; collisions only loosen
        # the bound. +256 keeps collisions among the true top-k negligible.
        kp = self.kprime if self.kprime > 0 else max(2 * eff_k, eff_k + 256)
        return min(kp, n)

    def _search(self, q: torch.Tensor, eff_k: int) -> ctops.CoverTreeSearchResult:
        meta, d = self.artifact.metadata, self.artifact.data
        args = (q, d["slab"], d["point_ids"], d["is_real"], d["radii"], d["parent_rel"])
        kw = dict(
            depth_sizes=tuple(meta["depth_sizes"]), k=eff_k,
            kprime=self._kprime(eff_k, meta["n_vectors"]), err_c=self.err_c,
        )
        if self.uses_blockwalk():
            return ctops.covertree_blockwalk_search(*args, prep=self.blockwalk_prep(), **kw)
        return ctops.covertree_stream_search(*args, **kw)

    def _rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The database rows in id order (``slab[row_pos]``) and their
        squared norms, made at the first fallback of an artifact."""
        d = self.artifact.data

        def make():
            rows = d["slab"][d["row_pos"].long()]
            return rows, dops.sq_norms(rows)

        return self._derive("rows", make)

    def _exact(self, q: torch.Tensor, eff_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The fallback: exact search over the database rows, ``(L2
        distances, ids)``."""
        rows, sqn = self._rows()
        fd, fi = dops.exact_search(q, rows, eff_k, metric="l2", db_sqnorms=sqn,
                                   refine=True, device=self.device)
        return torch.sqrt(torch.clamp(fd, min=0.0)), fi

    def _answer(self, qd: torch.Tensor, k: int):
        """Exact ``(dists, ids, ndis of the walk, flagged rows)`` on the
        device. The rows whose certificate failed (one host read of the
        batch's flags) are answered by exact search; the JAX package's
        ``lax.cond`` re-runs the whole batch instead, with the same exact
        neighbours. Cosine normalises and returns ``d^2 / 2 - 1``."""
        if self.metric == "cosine":
            qd = dops.normalize(qd)
        eff_k = min(k, self.artifact.metadata["n_vectors"])
        res = self._search(qd, eff_k)
        out_d, out_i = res.dists, res.ids.long()
        flagged = res.overflow.nonzero()[:, 0]
        if flagged.numel():
            out_d[flagged], out_i[flagged] = self._exact(qd[flagged], eff_k)
        if self.metric == "cosine":
            out_d = (out_d ** 2) / 2.0 - 1.0
        return out_d, out_i, res.ndis, int(flagged.numel())

    def batch_search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if not self.is_built or self.artifact is None:
            raise RuntimeError("index not built")
        out_d, out_i, (ndis, n_flagged) = host_search(
            lambda q: self._answer(q, k), queries, k, self.device)
        walk_ndis = int(ndis.sum())
        self._ndis_per_query = walk_ndis / max(queries.shape[0], 1)
        self.record_operation("ndis", walk_ndis + n_flagged * self.artifact.metadata["n_vectors"])
        return out_d, out_i

    def device_kernel(self, qd: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device queries in, device exact ``(dists, ids)`` out."""
        dists, ids, _, _ = self._answer(qd, k)
        return dists, ids

    @property
    def has_device_kernel(self) -> bool:
        return self.is_built and self.artifact is not None

    def record_stream_ops(self, n_queries: int) -> None:
        """Op accounting for the timed path (which bypasses batch_search):
        the per-query ``ndis`` of the warm-up batch."""
        self.record_operation("ndis", int(self._ndis_per_query * int(n_queries)))

    # -- persistence ----------------------------------------------------
    def save_index(self, path: str, context: Optional[Dict[str, Any]] = None) -> None:
        if self.artifact is None:
            raise RuntimeError("nothing to save")
        persist.save_artifact(self.artifact, path, context or {})

    def load_index(self, path: str, context: Optional[Dict[str, Any]] = None) -> None:
        ctx = dict(context or {})
        ctx["kind"] = "covertree"
        art = persist.load_artifact(path, ctx, device=self.device)
        if art.metadata.get("metric") != self.metric:
            raise ValueError(
                f"metric mismatch: saved {art.metadata.get('metric')!r} != "
                f"configured {self.metric!r}"
            )
        if art.metadata.get("dimension") != self.dimension:
            raise ValueError(
                f"dimension mismatch: saved {art.metadata.get('dimension')} "
                f"!= configured {self.dimension}"
            )
        if art.metadata.get("schema") != SCHEMA:
            raise ValueError(
                f"schema mismatch: saved {art.metadata.get('schema')!r} "
                f"!= {SCHEMA!r} (rebuild required: the block-aligned "
                "depth-major layout replaced the unaligned v3 layout)"
            )
        self.artifact = art
        self.is_built = True

    def get_parameters(self) -> Dict[str, Any]:
        p = super().get_parameters()
        p.update({
            "descent": self.descent,
            "kprime": self.kprime,
            "err_c": self.err_c,
            "max_fanout": self.max_fanout,
        })
        return p
