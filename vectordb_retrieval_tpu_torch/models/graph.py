"""Graph (HNSW-class) index family: ``GraphIndexer`` / ``HNSWIndexer`` and
the ``HNSW`` algorithm.

Counterpart of ``vectordb_retrieval_tpu/models/graph.py`` with the same
knobs, defaults and decisions. ``M`` / ``efConstruction`` / ``efSearch``
map onto graph degree ``R = 2M``, build quality (recorded; the build is an
exact or IVF-probed kNN graph) and the beam geometry. Two layouts, one
artifact kind ``graph``:

  * node mode: the RNG-pruned kNN graph with reverse edges, k-means entry
    points and, within ``nbr_table_budget_mb``, a bf16 or SQ8 neighbour
    table (``ops/graph.graph_search``);
  * block mode: the memory-parity block layout whose beam scores member
    slabs with kernel K2 (``ops/graph.block_graph_search``). ``auto`` takes
    it above ``_BLOCK_AUTO_THRESHOLD`` rows and keeps it when a 256-row
    self-check scores recall@10 >= 0.85, else builds node mode.

``ANNSearcher`` serves the artifact with a runtime ``efSearch``.
Out-of-core corpora (``np.memmap``, ``BigStore``) always build block mode,
streamed in sequential chunk passes (``ops/graph.build_block_graph_stream``),
with a self-check against a streamed exact search.
"""

from __future__ import annotations

import logging
from typing import Any, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.data.storage import (
    _read_chunk,
    corpus_to_device,
    is_out_of_core,
    streamed_exact_search,
)
from vectordb_retrieval_tpu_torch.models.base import (
    BaseIndexer,
    IndexArtifact,
    register_indexer,
)
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import graph as gops
from vectordb_retrieval_tpu_torch.utils.device import DeviceLike

# auto mode switches to the memory-parity block layout above this row count
_BLOCK_AUTO_THRESHOLD = 50_000
# default boundary-spill fraction for block-mode builds
_DEFAULT_SPILL = 0.0
# default member-slab dtype for block-mode builds ("auto"): bf16
# mean-centred residual slabs halve the wave bytes
_DEFAULT_SLAB_DTYPE = "bf16"
# the self-check recall@10 a block build must reach to be kept in auto mode
_SELFCHECK_MIN = 0.85
# artifact metadata names the slab dtype as the JAX package does
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


@register_indexer("GraphIndexer")
@register_indexer("HNSWIndexer")
class GraphIndexer(BaseIndexer):
    def __init__(
        self,
        metric: str = "l2",
        M: int = 16,
        efConstruction: int = 200,
        efSearch: int = 100,
        n_entry: int = 0,
        seed: int = 42,
        nbr_table: str = "auto",  # auto | on | off
        nbr_table_budget_mb: int = 2048,
        nbr_table_dtype: str = "auto",  # auto | bf16 | int8
        mode: str = "auto",  # auto | node | block
        block_size: int = 0,  # block mode: target rows per block (0 = auto)
        spill: float = -1.0,  # block mode: boundary-row clone fraction (<0 = auto)
        slab_dtype: str = "auto",  # block mode: f32 | bf16 member slabs
        reverse_edges: int = -1,  # node mode: incoming-link slots (<0 = 2M)
        device: DeviceLike = None,
        **params: Any,
    ):
        super().__init__(metric=metric, device=device, **params)
        self.M = int(M)
        self.reverse_edges = int(2 * M if reverse_edges < 0 else reverse_edges)
        self.efConstruction = int(efConstruction)
        self.efSearch = int(efSearch)
        self.n_entry = int(n_entry)  # 0 = auto (scales with N)
        self.seed = int(seed)
        self.nbr_table = str(nbr_table)
        self.nbr_table_budget_mb = int(nbr_table_budget_mb)
        self.nbr_table_dtype = str(nbr_table_dtype)
        if mode not in ("auto", "node", "block"):
            raise ValueError("mode must be 'auto', 'node' or 'block'")
        self.mode = mode
        self.block_size = int(block_size)
        self.spill = _DEFAULT_SPILL if spill < 0 else float(spill)
        if slab_dtype not in ("auto", "f32", "bf16"):
            raise ValueError("slab_dtype must be 'auto', 'f32' or 'bf16'")
        self.slab_dtype = _DEFAULT_SLAB_DTYPE if slab_dtype == "auto" else slab_dtype

    def _block_geom(self, n: int, d: int) -> Tuple[int, int]:
        """``(n_blocks, entry-graph degree)``. 128-row blocks, coarsened to
        256 rows where a 128-row slab is under 64 KB (the JAX package's
        DMA-knee rule, kept so both packages build the same layout); an
        entry-graph degree of 8."""
        if self.block_size:
            block = self.block_size
        else:
            itemsize = 2 if self.slab_dtype == "bf16" else 4
            block = 256 if 128 * d * itemsize < 65536 else 128
        n_blocks = max(1, -(-n // block))
        degree = max(4, min(8, n_blocks - 1))
        return n_blocks, degree

    def _build_block(self, x: torch.Tensor, dimension: int) -> IndexArtifact:
        n = x.shape[0]
        n_blocks, degree = self._block_geom(n, int(x.shape[1]))
        parts = gops.build_block_graph(
            x, n_blocks, degree, seed=self.seed, spill=self.spill,
            slab_dtype=self.slab_dtype,
        )
        return self._package_block(parts, dimension, n)

    def _build_block_stream(self, store, dimension: int) -> IndexArtifact:
        """Out-of-core block build: the memmap / BigStore corpus streamed in
        sequential passes; host RSS O(chunk), device memory the layout
        plus one chunk."""
        n = int(store.shape[0])
        n_blocks, degree = self._block_geom(n, dimension)
        parts = gops.build_block_graph_stream(
            store, n_blocks, degree, seed=self.seed,
            normalize=self.metric == "cosine", spill=self.spill,
            slab_dtype=self.slab_dtype, device=self.device,
        )
        art = self._package_block(parts, dimension, n)
        art.metadata["built_streaming"] = True
        return art

    def _package_block(self, parts, dimension: int, n: int) -> IndexArtifact:
        entries, entry_block, slot_ids, list_vecs, list_sqn, adj, mu = parts
        data = {
            "entries": entries,
            "entry_block": entry_block,
            "slot_ids": slot_ids,
            "list_vecs": list_vecs,
            "list_sqnorms": list_sqn,
            "entry_adj": adj,
        }
        if mu is not None:  # bf16 residual slabs carry f32 block means
            data["list_mu"] = mu
        return IndexArtifact(
            "graph",
            data,
            {
                "metric": self.metric,
                "dimension": int(dimension),
                "n_vectors": int(n),
                "normalize_queries": self.metric == "cosine",
                "M": self.M,
                "degree": int(adj.shape[1]),
                "efConstruction": self.efConstruction,
                "efSearch": self.efSearch,
                "mode": "block",
                "n_blocks": int(slot_ids.shape[0]),
                "n_entries": int(entries.shape[0]),
                "block_len": int(slot_ids.shape[1]),
                "spill": float(self.spill),
                "slab_dtype": _DTYPE_NAMES[list_vecs.dtype],
            },
        )

    def _block_selfcheck(self, artifact: IndexArtifact, x: torch.Tensor) -> float:
        """Routing-quality probe: recall@10 of 256 evenly spaced rows
        against exact search. Cluster routing needs cluster structure: on
        structureless corpora a row's true neighbours scatter over blocks."""
        from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k

        n = x.shape[0]
        idx = np.linspace(0, n - 1, num=min(256, n), dtype=np.int64)
        sample = x[torch.as_tensor(idx, device=x.device)]
        metric = "ip" if self.metric in ("ip", "cosine") else "l2"
        _, gt = dops.exact_search(sample, x, 10, metric=metric, device=x.device)
        _, got = graph_artifact_search(artifact, sample, 10, metric, self.efSearch)
        return float(recall_at_k(gt.cpu().numpy(), got.cpu().numpy(), 10))

    def _selfcheck_stream(self, artifact: IndexArtifact, store) -> float:
        """:meth:`_block_selfcheck` of an out-of-core corpus: 256 evenly
        spaced rows read from the store, their ground truth by a streamed
        exact search (O(chunk) memory)."""
        from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k

        n = int(store.shape[0])
        idx = np.linspace(0, n - 1, num=min(256, n), dtype=np.int64)
        sample = np.concatenate([_read_chunk(store, int(i), int(i) + 1) for i in idx])
        metric = "ip" if self.metric in ("ip", "cosine") else "l2"
        norm = self.metric == "cosine"
        if norm:
            sample /= np.maximum(np.linalg.norm(sample, axis=1, keepdims=True), 1e-12)
        _, gt = streamed_exact_search(
            sample, store, 10, metric=metric, normalize=norm, device=self.device)
        _, got = graph_artifact_search(
            artifact, torch.as_tensor(sample, device=self.device), 10, metric, self.efSearch)
        return float(recall_at_k(gt, got.cpu().numpy(), 10))

    def build(self, vectors: np.ndarray, dimension: int) -> IndexArtifact:
        if is_out_of_core(vectors):
            # larger-than-RAM corpora: the streamed block build (node mode
            # would need the corpus resident for its kNN graph and table)
            art = self._build_block_stream(vectors, dimension)
            art.metadata["selfcheck_recall"] = round(self._selfcheck_stream(art, vectors), 4)
            return art
        x = corpus_to_device(vectors, device=self.device)
        if self.metric == "cosine":
            x = dops.normalize(x)
        n = x.shape[0]
        if self.mode == "block" or (self.mode == "auto" and n > _BLOCK_AUTO_THRESHOLD):
            art = self._build_block(x, dimension)
            check = self._block_selfcheck(art, x)
            art.metadata["selfcheck_recall"] = round(float(check), 4)
            if check >= _SELFCHECK_MIN or self.mode == "block":
                if check < _SELFCHECK_MIN:
                    logging.getLogger(__name__).warning(
                        "block-mode graph self-check recall %.2f < %.2f "
                        "(structureless corpus?); mode='block' was explicit so "
                        "keeping it", check, _SELFCHECK_MIN,
                    )
                return art
            # auto + structureless corpus: the node beam handles it
            del art
        degree = min(2 * self.M, max(n - 1, 1))
        adjacency = gops.build_knn_graph(x, degree, reverse_edges=self.reverse_edges)
        # coarse-quantizer entries replace HNSW's upper layers; a dense seed
        # (~N/10, capped) lands the beam 1-2 hops from the answers
        n_entry = self.n_entry or min(2048, max(16, n // 10))
        entries = gops.pick_entry_points(x, min(n_entry, n), seed=self.seed)
        data = {
            "vectors": x,
            "sqnorms": dops.sq_norms(x),
            "adjacency": adjacency,
            "entry_ids": entries,
        }
        degree = int(adjacency.shape[1])  # forward + reverse slots
        bf16_mb = n * degree * int(dimension) * 2 / 1e6
        int8_mb = bf16_mb / 2
        dtype = self.nbr_table_dtype
        if dtype == "auto":
            # bf16 where it fits the budget, else the half-size SQ8 table
            dtype = "bf16" if bf16_mb <= self.nbr_table_budget_mb else "int8"
        table_mb = bf16_mb if dtype == "bf16" else int8_mb
        use_table = self.nbr_table == "on" or (
            self.nbr_table == "auto" and table_mb <= self.nbr_table_budget_mb
        )
        if use_table:
            nbr_vecs, nbr_sqn, nbr_vmin, nbr_step = gops.build_neighbor_table(
                x, adjacency, dtype="int8" if dtype == "int8" else "bf16",
            )
            data["nbr_vecs"] = nbr_vecs
            data["nbr_sqn"] = nbr_sqn
            if nbr_vmin is not None:
                data["nbr_vmin"] = nbr_vmin
                data["nbr_step"] = nbr_step
        return IndexArtifact(
            "graph",
            data,
            {
                "metric": self.metric,
                "dimension": int(dimension),
                "n_vectors": int(n),
                "normalize_queries": self.metric == "cosine",
                "M": self.M,
                "degree": degree,
                "efConstruction": self.efConstruction,
                "efSearch": self.efSearch,
                "nbr_table": bool(use_table),
            },
        )


def beam_geometry(n: int, degree: int, ef_search: int, k: int):
    """Node-beam geometry ``(ef, expand, keep, iters)``: a beam of ~1.25 x
    efSearch, ~1536 scored rows per iteration (W = 1536 / R), an insert cap
    of ~0.75 ef, and 4 iterations growing with N. One source for the
    serving path and the op-count estimate."""
    ef = max(int(ef_search * 1.25), k + 8, 16)
    ef = min(ef, n)
    expand = min(max(8, min(ef, 1536 // max(degree, 1))), ef)
    keep = max(k, (3 * ef) // 4)
    iters = 4 + (n > 50_000) + (n > 500_000)
    iters = max(iters, -(-ef // keep) + 1)
    return ef, expand, keep, iters


def block_geometry(n_blocks: int, ef_search: int, k: int, block_len: int = 128):
    """Block-beam geometry ``(efb, expand, iters)``.

    efSearch maps to a row budget of ~245 member rows per efSearch (the
    JAX package's calibration on the MS MARCO surrogate), spent in waves of
    up to 96 slabs; the frontier holds two waves.
    """
    probes = max(8, min(-(-(ef_search * 245) // max(block_len, 1)), n_blocks))
    iters = max(1, -(-probes // 96))
    expand = -(-probes // iters)
    efb = min(max(2 * expand, 48), n_blocks)
    return efb, expand, iters


def graph_artifact_search(
    artifact: IndexArtifact,
    q: torch.Tensor,
    k: int,
    metric: str,
    ef_search: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search a ``graph`` artifact of either mode at ``ef_search``."""
    meta = artifact.metadata
    data = artifact.data
    n = meta["n_vectors"]
    if meta.get("mode") == "block":
        efb, expand, iters = block_geometry(
            int(meta["n_blocks"]), ef_search, k,
            block_len=int(meta.get("block_len", 128)),
        )
        return gops.block_graph_search(
            q, data["entries"], data["entry_block"], data["slot_ids"],
            data["list_vecs"], data["list_sqnorms"], data["entry_adj"],
            data.get("list_mu"), k=k, efb=efb, expand=expand, iters=iters,
            metric=metric, dedup=float(meta.get("spill", 0.0)) > 0.0,
        )
    degree = int(meta.get("degree", data["adjacency"].shape[1]))
    ef, expand, keep, iters = beam_geometry(n, degree, ef_search, k)
    nbr_vecs = data.get("nbr_vecs")
    return gops.graph_search(
        q, data["vectors"], data["adjacency"], data["entry_ids"], k,
        ef=ef, expand=expand, iters=iters, metric=metric,
        sqnorms=data.get("sqnorms"), cand_keep=keep, nbr_vecs=nbr_vecs,
        nbr_sqn=data.get("nbr_sqn"),
        rescore=nbr_vecs is not None,  # quantised routing -> exact re-rank
        nbr_vmin=data.get("nbr_vmin"), nbr_step=data.get("nbr_step"),
    )


class HNSW(CompositeAlgorithm):
    """Standalone HNSW-class algorithm: ``GraphIndexer`` + ``ANNSearcher``."""

    def __init__(
        self,
        dimension: int,
        metric: str = "l2",
        M: int = 16,
        efConstruction: int = 200,
        efSearch: int = 100,
        device: DeviceLike = None,
        **params: Any,
    ):
        super().__init__(
            dimension=dimension,
            metric=metric,
            indexer={
                "type": "GraphIndexer",
                "M": M,
                "efConstruction": efConstruction,
                "efSearch": efSearch,
            },
            searcher={"type": "ANNSearcher", "efSearch": efSearch},
            name="HNSW",
            device=device,
            **params,
        )
