"""LSH index family: multi-table LSH and binary-Hamming LSH.

Counterpart of ``vectordb_retrieval_tpu/models/lsh.py``, with the same
artifacts (kinds ``lsh`` and ``binary_lsh``, same keys and metadata), so
either package loads the other's index through ``models/persist.py``:

  * ``LSHIndexer`` / ``LSHSearcher``: sign-hash (cosine) or E2LSH
    floor-hash (l2) keys over ``num_tables`` tables, candidates by
    table-collision votes, an exact rerank, and optionally exact search for
    the queries left with fewer than k candidates;
  * ``BinaryLSHIndexer`` (also ``FaissLSHIndexer``), served by
    ``ANNSearcher``'s ``binary_lsh`` kind through :func:`binary_lsh_search`:
    Hamming candidates, then an exact rerank, by gathering up to
    ``_GATHER_RERANK_MAX_CANDS`` candidates a query and by a dense pass over
    every row within the Hamming radius above;
  * ``LSH``, the indexer/searcher pair as one algorithm.

Projections come from a seeded CPU ``torch.Generator``, so an index built
on the card and one built on the host hash alike; the JAX package draws
them from ``jax.random``, so its builds hash otherwise (its artifacts carry
their projections, and search the same in both packages).
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.data.storage import corpus_to_device
from vectordb_retrieval_tpu_torch.models.base import (
    BaseIndexer,
    BaseSearcher,
    IndexArtifact,
    check_artifact_device,
    register_indexer,
    register_searcher,
)
from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import lsh as lshops

# binary-LSH rerank strategy crossover: above this many candidates per
# query the gather-based exact rerank loses to the gather-free dense
# threshold pass (the JAX package's measured crossover, kept so that both
# packages take the same path at the same parameters)
_GATHER_RERANK_MAX_CANDS = 256


def _score_metric(metric: str) -> str:
    return "ip" if metric in ("ip", "cosine") else "l2"


@register_indexer("LSHIndexer")
class LSHIndexer(BaseIndexer):
    def __init__(
        self,
        metric: str = "l2",
        num_tables: int = 12,
        hash_size: int = 18,
        bucket_width: float = 4.0,
        seed: int = 42,
        **params: Any,
    ):
        super().__init__(metric=metric, **params)
        if hash_size > 30:
            raise ValueError("hash_size must be <= 30 (int32 key packing)")
        self.num_tables = int(num_tables)
        self.hash_size = int(hash_size)
        self.bucket_width = float(bucket_width)
        self.seed = int(seed)

    def build(self, vectors: np.ndarray, dimension: int) -> IndexArtifact:
        x = corpus_to_device(vectors, device=self.device)
        if self.metric == "cosine":
            x = dops.normalize(x)
        proj = lshops.make_projections(
            self.seed, self.num_tables, self.hash_size, int(dimension), device=self.device
        )
        data = {"vectors": x, "projections": proj}
        if self.metric == "cosine":
            keys = lshops.sign_keys(x, proj)
        else:
            offsets = lshops.make_offsets(
                self.seed, self.num_tables, self.hash_size, self.bucket_width,
                device=self.device,
            )
            keys = lshops.e2lsh_keys(x, proj, offsets, self.bucket_width)
            data["offsets"] = offsets
        data["db_keys"] = keys
        return IndexArtifact(
            "lsh",
            data,
            {
                "metric": self.metric,
                "dimension": int(dimension),
                "n_vectors": int(x.shape[0]),
                "normalize_queries": self.metric == "cosine",
                "num_tables": self.num_tables,
                "hash_size": self.hash_size,
                "bucket_width": self.bucket_width,
            },
        )


@register_searcher("LSHSearcher")
class LSHSearcher(BaseSearcher):
    """Hash, vote, rerank; with ``fallback_to_bruteforce`` the queries left
    with fewer than k candidates are answered by exact search (only those
    rows, after one host read of the batch's short flags; the JAX package's
    ``lax.cond`` re-runs the whole batch, with the same neighbours)."""

    def __init__(
        self,
        metric: str = "l2",
        candidate_multiplier: float = 8.0,
        fallback_to_bruteforce: bool = True,
        **params: Any,
    ):
        super().__init__(metric=metric, **params)
        self.candidate_multiplier = float(candidate_multiplier)
        self.fallback_to_bruteforce = bool(fallback_to_bruteforce)

    def attach(self, artifact: IndexArtifact) -> None:
        if artifact.kind != "lsh":
            raise ValueError(f"LSHSearcher needs an 'lsh' artifact, got {artifact.kind!r}")
        check_artifact_device(artifact, self.device)
        self.artifact = artifact

    def _n_candidates(self, k: int, n: int) -> int:
        c = max(int(math.ceil(self.candidate_multiplier * k)), k)
        return min(c, n)

    # -- the search, stage by stage --------------------------------------
    def hash_queries(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(queries as searched, their keys [B, T])``."""
        art = self.artifact
        meta = art.metadata
        if meta.get("normalize_queries"):
            q = dops.normalize(q)
        if meta["metric"] == "cosine":
            return q, lshops.sign_keys(q, art.data["projections"])
        return q, lshops.e2lsh_keys(
            q, art.data["projections"], art.data["offsets"], meta["bucket_width"]
        )

    def vote(self, qkeys: torch.Tensor, eff_k: int) -> torch.Tensor:
        """Candidate ids ``[B, C]`` by votes, -1 where no table collided."""
        n_cand = self._n_candidates(eff_k, self.artifact.metadata["n_vectors"])
        votes, cand = lshops.vote_candidates(qkeys, self.artifact.data["db_keys"], n_cand)
        return torch.where(votes > 0, cand, -1)

    def rerank(self, q: torch.Tensor, cand: torch.Tensor, eff_k: int):
        metric = _score_metric(self.artifact.metadata["metric"])
        return lshops.rerank(q, self.artifact.data["vectors"], cand, eff_k, metric=metric)

    def fallback(self, q: torch.Tensor, eff_k: int):
        """Exact search of ``q`` over the indexed vectors."""
        metric = _score_metric(self.artifact.metadata["metric"])
        return dops.exact_search(q, self.artifact.data["vectors"], eff_k, metric=metric,
                                 refine=True, device=self.device)

    def _answer(self, q: torch.Tensor, k: int):
        """``(dists, ids, rows answered by exact search)`` on the device."""
        eff_k = min(k, self.artifact.metadata["n_vectors"])
        q, qkeys = self.hash_queries(q)
        dists, ids = self.rerank(q, self.vote(qkeys, eff_k), eff_k)
        if not self.fallback_to_bruteforce:
            return dists, ids, 0
        short = ((ids >= 0).sum(dim=1) < eff_k).nonzero()[:, 0]
        if short.numel():
            dists[short], ids[short] = self.fallback(q[short], eff_k)
        return dists, ids, int(short.numel())

    def device_kernel(self, q: torch.Tensor, k: int):
        """Device queries in, device ``(dists, ids)`` out; no host copy of
        the results."""
        dists, ids, _ = self._answer(q, k)
        return dists, ids

    def estimated_ops_per_query(self, n_database: int) -> int:
        # votes are key compares, not distance ops; the rerank is the cost
        if self.artifact is None:
            return n_database
        return self._n_candidates(10, n_database)


@register_indexer("BinaryLSHIndexer")
@register_indexer("FaissLSHIndexer")
class BinaryLSHIndexer(BaseIndexer):
    """Binary hyperplane hashing (FAISS ``IndexLSH`` equivalent)."""

    def __init__(self, metric: str = "l2", num_bits: int = 256, seed: int = 42,
                 **params: Any):
        super().__init__(metric=metric, **params)
        self.num_bits = int(num_bits)
        self.seed = int(seed)

    def build(self, vectors: np.ndarray, dimension: int) -> IndexArtifact:
        x = corpus_to_device(vectors, device=self.device)
        if self.metric == "cosine":
            x = dops.normalize(x)
        proj = torch.randn(
            (int(dimension), self.num_bits), generator=lshops.seeded_generator(self.seed)
        ).to(self.device)
        return IndexArtifact(
            "binary_lsh",
            {"vectors": x, "words": binary_words(x, proj), "projections": proj},
            {
                "metric": self.metric,
                "dimension": int(dimension),
                "n_vectors": int(x.shape[0]),
                "normalize_queries": self.metric == "cosine",
                "num_bits": self.num_bits,
                "index_kind": "lsh",
            },
        )


def binary_words(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Packed sign bits of ``x @ proj`` (f32 products), ``[N, nbits / 32]``
    int32, computed in row chunks."""
    n, nbits = x.shape[0], proj.shape[1]
    out = torch.empty((n, -(-nbits // 32)), dtype=torch.int32, device=x.device)
    step = lshops.chunk_rows(nbits * 8, n)
    for s in range(0, n, step):
        out[s : s + step] = lshops.pack_bits(torch.matmul(x[s : s + step], proj) > 0)
    return out


def binary_n_candidates(artifact: IndexArtifact, k: int, multiplier: float) -> int:
    return min(max(int(math.ceil(multiplier * k)), k), artifact.metadata["n_vectors"])


def binary_rerank_path(n_cand: int) -> str:
    """``'threshold'`` (the dense pass) or ``'gather'``."""
    return "threshold" if n_cand > _GATHER_RERANK_MAX_CANDS else "gather"


def binary_lsh_search(
    artifact: IndexArtifact,
    q: torch.Tensor,
    k: int,
    metric: str,
    multiplier: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hamming candidates + exact rerank over a ``binary_lsh`` artifact."""
    d = artifact.data
    qwords = binary_words(q, d["projections"])
    n_cand = binary_n_candidates(artifact, k, multiplier)
    ham, cand = lshops.hamming_candidates(qwords, d["words"], n_cand)
    if binary_rerank_path(n_cand) == "threshold":
        # the radius-threshold candidate set is the argsort cut plus every
        # row tied at the radius: a superset, so recall can only improve
        return lshops.hamming_threshold_rerank(
            q, qwords, d["vectors"], d["words"], ham[:, -1:], k, metric=metric
        )
    return lshops.rerank(q, d["vectors"], cand, k, metric=metric)


class LSH(CompositeAlgorithm):
    """The multi-table LSH indexer/searcher pair as one algorithm."""

    def __init__(
        self,
        dimension: int,
        metric: str = "l2",
        num_tables: int = 12,
        hash_size: int = 18,
        bucket_width: float = 4.0,
        seed: int = 42,
        candidate_multiplier: float = 8.0,
        fallback_to_bruteforce: bool = True,
        **params: Any,
    ):
        super().__init__(
            dimension=dimension,
            metric=metric,
            indexer={
                "type": "LSHIndexer",
                "num_tables": num_tables,
                "hash_size": hash_size,
                "bucket_width": bucket_width,
                "seed": seed,
            },
            searcher={
                "type": "LSHSearcher",
                "candidate_multiplier": candidate_multiplier,
                "fallback_to_bruteforce": fallback_to_bruteforce,
            },
            name="LSH",
            **params,
        )
