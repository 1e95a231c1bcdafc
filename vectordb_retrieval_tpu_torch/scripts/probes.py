"""What the research probes share: the timing protocol of repeated device
searches, and the GloVe-50 surrogate's node-beam setup
(``exp_glove_ceiling``, ``exp_glove_geometry``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import graph as gops
from vectordb_retrieval_tpu_torch.utils.device import synchronize

Search = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def timed_passes(search: Search, q: torch.Tensor, passes: int,
                 device: torch.device) -> Tuple[np.ndarray, float]:
    """``(ids of the last pass on the host, seconds of the passes)``: one
    untimed ``search(q)``, then ``passes`` calls queued on the device, one
    synchronise and one copy of the last ids to the host inside the clock
    (``bench/experiment._timed_search``'s protocol, with a single sync)."""
    search(q)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(passes):
        _, ids = search(q)
    synchronize(device)
    out = ids.cpu().numpy()
    return out, time.perf_counter() - t0


class GloveBeam:
    """The GloVe-50 surrogate at its loader's defaults (20k x 50, l2), its
    first 256 queries and their exact top-``k``, and the node beam over a
    kNN graph of forward degree 2M with entry points from a seeded k-means
    (``ops/graph.pick_entry_points``), as both GloVe probes set it up."""

    M = 16

    def __init__(self, k: int, data_dir: str, device: torch.device):
        ds = Dataset("glove50_surrogate", data_dir=data_dir, options={}, device=device).load()
        self.x = torch.as_tensor(np.asarray(ds.train_vectors, dtype=np.float32), device=device)
        self.q = torch.as_tensor(np.asarray(ds.test_vectors, dtype=np.float32), device=device)[:256]
        self.k = k
        _, gt = dops.exact_search(self.q, self.x, k, metric="l2", device=device)
        self.gt = gt.cpu().numpy()
        self.entries = gops.pick_entry_points(self.x, min(2048, self.x.shape[0]), seed=42)
        self.sqn = dops.sq_norms(self.x)

    def graph(self, reverse_edges: int) -> torch.Tensor:
        """The RNG-pruned kNN graph with ``reverse_edges`` incoming-link slots."""
        return gops.build_knn_graph(self.x, 2 * self.M, reverse_edges=reverse_edges)

    def search(self, adj: torch.Tensor, ef: int, iters: int,
               expand: Optional[int] = None) -> np.ndarray:
        """The beam's ids ``[256, k]`` on the host; ``expand`` defaults to
        ``min(max(8, 1536 // degree), ef)`` and the candidates kept to
        ``max(k, 3 ef / 4)``."""
        expand = expand or min(max(8, 1536 // adj.shape[1]), ef)
        _, ids = gops.graph_search(
            self.q, self.x, adj, self.entries, self.k, ef=ef, expand=expand,
            iters=iters, metric="l2", sqnorms=self.sqn,
            cand_keep=max(self.k, 3 * ef // 4),
        )
        return ids.cpu().numpy()

    def recall(self, ids: np.ndarray) -> float:
        return recall_at_k(self.gt, ids, self.k)
