"""What the research and tuning probes share: the timing protocol of
repeated device searches (and of a stream of batches), the exact
references, agreement counts and recalls the tuning probes report, and the
GloVe-50 surrogate's node-beam setup (``exp_glove_ceiling``,
``exp_glove_geometry``).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import graph as gops
from vectordb_retrieval_tpu_torch.utils.device import synchronize

Search = Callable[[torch.Tensor], Union[torch.Tensor, Sequence[torch.Tensor]]]


# the node-beam probes' pass line (the JAX scripts' own): BASELINE.md's
# FAISS CPU hnsw row on random-20k, 23,886 QPS at recall@20 0.9156
BEAM_PASS_QPS, BEAM_PASS_RECALL = 23886, 0.9156

# Two exact f32 distances summed in different orders (exact search's block
# rescore, K6, and the plain route's gathered sum) differ by a few ulps, so
# rows whose distances lie that close may rank either way: 8 ulps (2^-21)
# of the distance
F32_TIE_REL = 2.0 ** -21


def pad_rows(n: int, w: int) -> int:
    """The JAX package's padding of a K1 payload: a multiple of ``8 w`` rows
    (the K1 probes pad so, so that their block ids match the JAX
    scripts')."""
    return -(-n // (8 * w)) * (8 * w)


def set_first(v: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``v`` with its first columns replaced by ``head`` (``.at[:, :k].set``)."""
    return torch.cat([head, v[:, head.shape[1]:]], dim=1)


def timed_passes(search: Search, q: torch.Tensor, passes: int,
                 device: torch.device) -> Tuple[np.ndarray, float]:
    """``(the last pass's result on the host, seconds of the passes)``: one
    untimed ``search(q)``, then ``passes`` calls queued on the device, one
    synchronise and one copy of the last result to the host inside the
    clock (``bench/experiment._timed_search``'s protocol, with a single
    sync). ``search`` returns a tensor or a tuple of tensors, whose last
    (a search's ids) is the result copied (bf16 as f32)."""
    search(q)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(passes):
        out = search(q)
    synchronize(device)
    last = out[-1] if isinstance(out, (tuple, list)) else out
    host = last.cpu()
    host = (host.float() if host.dtype == torch.bfloat16 else host).numpy()
    return host, time.perf_counter() - t0


def timed_batches(search: Search, queries: torch.Tensor,
                  device: torch.device) -> Tuple[np.ndarray, float]:
    """``(the first batch's result on the host, seconds of the stream)``:
    ``search`` over every batch of ``queries [reps, B, d]`` in turn, timed
    as one pass of :func:`timed_passes` (the beam probes' protocol: the JAX
    scripts scan the batches in one ``jit`` and score the first batch)."""
    return timed_passes(lambda qs: [search(qb) for qb in qs][0], queries, 1, device)


def beam_inputs(n: int, d: int, b: int, repeats: int) -> Tuple[np.ndarray, np.ndarray]:
    """The corpus ``[n, d]`` and query batches ``[repeats, b, d]`` that the
    node-beam probes draw first (NumPy seed 42, in that order)."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x, rng.standard_normal((repeats, b, d)).astype(np.float32)


def set_recall(ids: np.ndarray, gt: np.ndarray) -> float:
    """Recall of ``ids [B, k]`` against ``gt [B, k]`` as the beam probes
    count it: the shared ids of each row, over ``B k``."""
    hits = sum(len(set(ids[i].tolist()) & set(gt[i].tolist())) for i in range(gt.shape[0]))
    return hits / float(gt.shape[0] * gt.shape[1])


def selection_inputs(c: int, b: int, repeats: int) -> Tuple[np.ndarray, np.ndarray]:
    """The selection-cost probes' inputs: the values ``[b, c]`` every
    batch's chain starts from (NumPy seed 1) and the batches ``[repeats, b,
    8]`` that pace the stream (seed 0)."""
    vals0 = np.random.default_rng(1).standard_normal((b, c)).astype(np.float32)
    qs = np.random.default_rng(0).standard_normal((repeats, b, 8)).astype(np.float32)
    return vals0, qs


def time_selection(body: Callable[[torch.Tensor], torch.Tensor], label: str,
                   vals0: torch.Tensor, qs: torch.Tensor, iters: int,
                   device: torch.device) -> np.ndarray:
    """Time ``body`` chained ``iters`` times from ``vals0`` (each batch of
    ``qs`` starts a chain from ``vals0`` plus a carry of the previous
    chains' sums), as the selection-cost probes do; print the label's line
    (ms a batch) and return the last batch's first 8 columns. One untimed
    stream, then one timed (:func:`timed_passes`); the host issues every
    operation of the chains."""

    def run(batches):
        carry = torch.zeros((), device=vals0.device)
        for qb in batches:
            v = vals0 + carry
            for _ in range(iters):
                v = body(v)
            carry = carry + v.sum() * 1e-30 + qb.sum() * 1e-30
        return v[:, :8]

    out, elapsed = timed_passes(run, qs, 1, device)
    print(f"{label:56s} {elapsed / qs.shape[0] * 1000:9.2f} ms/batch")
    return out


def dense_reference(q: torch.Tensor, x: torch.Tensor, k: int,
                    chunk_rows: int = 65_536) -> Tuple[np.ndarray, np.ndarray]:
    """Exact l2 top-``k`` of ``q`` over ``x`` on the host, by the plain
    route: f32 products in row chunks with a running top-k (TF32 off), then
    the cancellation-free rescore of ``k + REFINE_OVERFETCH`` candidates
    (``ops/distances._exact_search_streamed``). No kernel runs."""
    fetch = min(k + dops.REFINE_OVERFETCH, x.shape[0])
    d, i = dops._exact_search_streamed(q, x, None, fetch, "l2", chunk_rows, refine_to=k)
    return d.cpu().numpy(), i.cpu().numpy()


def agree_where_distinct(ids: np.ndarray, ref_ids: np.ndarray,
                         ref_d: np.ndarray) -> float:
    """Share of the positions whose reference distance differs from both
    neighbours in its row by more than ``F32_TIE_REL`` of its value (its
    rank is certain) where ``ids`` holds the reference's id; 1.0 where no
    position is certain."""
    ref_d = np.asarray(ref_d)
    prev = np.concatenate([np.full((ref_d.shape[0], 1), -np.inf), ref_d[:, :-1]], axis=1)
    nxt = np.concatenate([ref_d[:, 1:], np.full((ref_d.shape[0], 1), np.inf)], axis=1)
    tie = F32_TIE_REL * np.abs(ref_d)
    certain = (np.abs(ref_d - prev) > tie) & (np.abs(nxt - ref_d) > tie)
    if not certain.any():
        return 1.0
    return float(np.mean(np.asarray(ids)[certain] == np.asarray(ref_ids)[certain]))


def print_check(**numbers) -> None:
    """The numbers a probe's correctness gate reads, as one last line
    ``check {json}`` (the JAX scripts print none of it)."""
    print("check " + json.dumps(numbers), flush=True)


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
