"""Hashing TF-IDF text vectorizer (pure NumPy) + random projection.

Counterpart of ``vectordb_retrieval_tpu/data/tfidf.py`` (a copy: the same
NumPy arithmetic, so the same texts give bit-identical vectors in both
packages), plus :func:`read_tsv`, the JAX package's reader of ``id<TAB>text``
files (``data/dataprep/embed_msmarco.py``). Tokens hash into a fixed-width
feature space (signed hashing-trick buckets), tf-idf weighting is computed
from streamed document frequencies, and a gaussian random projection brings
vectors to the target dimensionality.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, List, Optional, Tuple

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")
_FNV_PRIME = 1099511628211
_FNV_OFFSET = 14695981039346656037
_MASK64 = (1 << 64) - 1


def read_tsv(path: str) -> Tuple[List[str], List[str]]:
    """``(ids, texts)`` of an ``id<TAB>text`` file; lines without a tab are
    skipped."""
    ids, texts = [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t", 1)
            if len(parts) == 2:
                ids.append(parts[0])
                texts.append(parts[1])
    return ids, texts


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


def _hash_token(token: str) -> int:
    h = _FNV_OFFSET
    for ch in token.encode("utf-8"):
        h = ((h ^ ch) * _FNV_PRIME) & _MASK64
    return h


class HashingTfidfVectorizer:
    """Fit document frequencies, transform texts to L2-normalised tf-idf.

    ``n_features`` buckets with the signed hashing trick (sign from an
    independent bit of the hash) keeps collisions unbiased.
    """

    def __init__(self, n_features: int = 4096, seed: int = 0):
        self.n_features = int(n_features)
        self.seed = int(seed)
        self.idf_: Optional[np.ndarray] = None
        self.n_docs_ = 0

    def _bucket(self, token: str) -> Tuple[int, float]:
        h = _hash_token(token) ^ (self.seed * 0x9E3779B97F4A7C15 & (2**64 - 1))
        return h % self.n_features, 1.0 if (h >> 63) & 1 == 0 else -1.0

    def fit(self, texts: Iterable[str]) -> "HashingTfidfVectorizer":
        df = np.zeros(self.n_features, dtype=np.int64)
        n_docs = 0
        for text in texts:
            n_docs += 1
            seen = {self._bucket(t)[0] for t in _tokenize(text)}
            for b in seen:
                df[b] += 1
        self.n_docs_ = n_docs
        # smooth idf (sklearn convention)
        self.idf_ = np.log((1.0 + n_docs) / (1.0 + df)) + 1.0
        return self

    def transform(self, texts: Iterable[str]) -> np.ndarray:
        if self.idf_ is None:
            raise RuntimeError("fit() first")
        idf = self.idf_.astype(np.float32)
        rows = []
        for text in texts:
            vec = np.zeros(self.n_features, dtype=np.float32)
            for t in _tokenize(text):
                b, sign = self._bucket(t)
                vec[b] += sign
            vec = vec * idf
            norm = float(np.linalg.norm(vec))
            rows.append(vec / norm if norm > 0 else vec)
        return np.stack(rows) if rows else np.zeros((0, self.n_features), np.float32)

    def fit_transform(self, texts: List[str]) -> np.ndarray:
        return self.fit(texts).transform(texts)


def random_projection(
    x: np.ndarray, dim: int, seed: int = 0
) -> np.ndarray:
    """Gaussian JL projection to ``dim`` + L2 renormalisation."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((x.shape[1], dim)).astype(np.float32)
    proj /= math.sqrt(dim)
    out = x @ proj
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-12)


def texts_to_vectors(
    texts: List[str],
    dim: int = 384,
    n_features: int = 4096,
    seed: int = 0,
    vectorizer: Optional[HashingTfidfVectorizer] = None,
) -> Tuple[np.ndarray, HashingTfidfVectorizer]:
    """TSV text rows -> unit vectors of width ``dim`` (tf-idf + projection)."""
    if vectorizer is None:
        vectorizer = HashingTfidfVectorizer(n_features=n_features, seed=seed)
        tfidf = vectorizer.fit_transform(texts)
    else:
        tfidf = vectorizer.transform(texts)
    return random_projection(tfidf, dim, seed=seed ^ 0x7F), vectorizer
