"""The plain reference: exact distances, top-k, k-means, and the judge.

Plain PyTorch, independent of the program under test: it imports nothing of
``vectordb_retrieval_tpu_torch`` (nor JAX), takes the raw corpus and query
pool that the benchmark generated, and works out again whatever an index
derives from them. ``fmt=None`` computes in float64 (the reference).
``fmt`` in :data:`FORMATS` computes in float32 with every product's inputs
rounded to that format first, as a tensor core of that precision would
(the control: the reference in a lower precision).

Distances follow the program's convention: squared L2 for ``l2``, the
negated inner product of unit rows for ``cosine`` (ascending = nearer).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# precisions the control may take, each below float32 with TF32 off
FORMATS = ("tf32", "bf16", "fp8")
# two distances closer than this share of the row's scale are a tie: f32
# rounding of a rescored distance (the program's exact stage) stays far
# below it, a lower precision's errors far above
TIE = 1e-6
# float64 elements one block of the reference may hold on the device
BLOCK_ELEMS = 1 << 27


def round_to(x: torch.Tensor, fmt: Optional[str]) -> torch.Tensor:
    """``x`` (f32) rounded to ``fmt`` and back to f32; None leaves it."""
    if fmt is None:
        return x
    if fmt == "tf32":  # 10 mantissa bits, round to nearest even
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        return bits.view(torch.float32)
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if fmt == "fp8":
        return x.to(torch.float8_e4m3fn).to(torch.float32)
    raise ValueError(f"unknown precision {fmt!r}; expected one of {FORMATS}")


def work_dtype(fmt: Optional[str]) -> torch.dtype:
    return torch.float64 if fmt is None else torch.float32


def prepare(x: np.ndarray, metric: str, device, fmt: Optional[str] = None) -> torch.Tensor:
    """Rows on ``device`` in the working type, unit rows for cosine."""
    t = torch.as_tensor(x, device=device).to(work_dtype(fmt))
    if metric == "cosine":
        t = t / torch.clamp(torch.linalg.norm(t, dim=1, keepdim=True), min=1e-12)
    return t


def pairwise(q: torch.Tensor, x: torch.Tensor, metric: str, fmt: Optional[str] = None,
             x_sqn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[b, n]`` distances of ``q [b, d]`` to ``x [n, d]``."""
    dots = round_to(q, fmt) @ round_to(x, fmt).T
    if metric == "l2":
        xn = x_sqn if x_sqn is not None else torch.sum(x * x, dim=1)
        return torch.clamp(torch.sum(q * q, dim=1)[:, None] + xn[None, :] - 2.0 * dots, min=0.0)
    return -dots


def pair_distances(q: torch.Tensor, rows: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances of ``q [r, d]`` to ``rows [r, k, d]``, elementwise (no
    product: a difference sum for l2)."""
    if metric == "l2":
        diff = rows - q[:, None, :]
        return torch.sum(diff * diff, dim=-1)
    return -torch.sum(rows * q[:, None, :], dim=-1)


def chunks(n: int, per: int) -> Iterable[Tuple[int, int]]:
    per = max(1, per)
    for a in range(0, n, per):
        yield a, min(a + per, n)


def exact_topk(q: torch.Tensor, x: torch.Tensor, k: int, metric: str,
               fmt: Optional[str] = None, row_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of ``x`` for each query, in blocks of queries.
    ``row_mask(a, b) -> [b - a, n] bool`` keeps only the rows a query may
    return (the IVF guarantee's probed lists)."""
    n = x.shape[0]
    x_sqn = torch.sum(x * x, dim=1) if metric == "l2" else None
    out_d, out_i = [], []
    for a, b in chunks(q.shape[0], BLOCK_ELEMS // max(n, 1)):
        d = pairwise(q[a:b], x, metric, fmt, x_sqn)
        if row_mask is not None:
            d = torch.where(row_mask(a, b), d, torch.full_like(d, float("inf")))
        vd, vi = torch.topk(d, min(k, n), dim=1, largest=False, sorted=True)
        out_d.append(vd)
        out_i.append(vi)
    return torch.cat(out_d), torch.cat(out_i)


def nearest(x: torch.Tensor, c: torch.Tensor, fmt: Optional[str] = None) -> torch.Tensor:
    """Nearest row of ``c`` (squared L2) for every row of ``x``."""
    c_sqn = torch.sum(c * c, dim=1)
    out = []
    for a, b in chunks(x.shape[0], BLOCK_ELEMS // max(c.shape[0], 1)):
        out.append(torch.argmin(pairwise(x[a:b], c, "l2", fmt, c_sqn), dim=1))
    return torch.cat(out)


def permutation(n: int, seed: int) -> torch.Tensor:
    """``torch.randperm(n)`` from a CPU generator seeded with ``seed``: the
    documented draw of an index's training sample and k-means init."""
    return torch.randperm(n, generator=torch.Generator(device="cpu").manual_seed(int(seed)))


def kmeans(train: torch.Tensor, init: torch.Tensor, iters: int,
           fmt: Optional[str] = None) -> torch.Tensor:
    """Lloyd's iterations from ``init``; an empty cluster keeps its centroid."""
    c = init.clone()
    k = c.shape[0]
    for _ in range(iters):
        a = nearest(train, c, fmt)
        sums = torch.zeros_like(c).index_add_(0, a, train)
        counts = torch.bincount(a, minlength=k).to(c.dtype)
        c = torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), c)
    return c


def pool_rows(offsets: Sequence[int], batch: int, pool: int) -> np.ndarray:
    """Pool index of every answered row: request ``r`` asked for the rows
    ``offsets[r] + [0, batch)`` of the pool, wrapping round."""
    return ((np.asarray(offsets, dtype=np.int64)[:, None] + np.arange(batch)) % pool).reshape(-1)


def judge(
    answers: List[Tuple[int, np.ndarray, np.ndarray]],
    batch: int,
    k: int,
    x: torch.Tensor,
    q: torch.Tensor,
    metric: str,
    expected_d: torch.Tensor,
    exact_d: torch.Tensor,
) -> Dict[str, float]:
    """Judge every answered request against the reference.

    ``answers``: ``(pool offset, distances [batch, k], ids [batch, k])`` as
    the timed path returned them. ``x``, ``q``: the corpus and the pool in
    the reference's rows; ``expected_d [P, k]``: the distances of the
    answers the guarantee promises, sorted; ``exact_d [P, k]``: the exact
    ones (for recall). Each answer's ids are scored again from the corpus.

    Returns ``bad_rows`` (rows of the wrong shape, with ids out of range,
    -1 or repeated), ``topk_gap`` (the widest excess, over the promised
    distance at the same rank, of the answer's own sorted distances),
    ``wrong_share`` (the share of answered entries beyond a tie in that
    excess), ``dist_err`` (the widest gap between a returned distance and
    its id's) and ``recall`` (the share of answered entries within the
    exact k-th distance, ties counted as hits), each gap as a share of the
    row's scale: the exact k-th distance for l2, 1 for unit rows.
    """
    n, pool = x.shape[0], q.shape[0]
    dev = x.device
    scale_all = exact_d[:, -1].abs().clamp(min=1e-30) if metric == "l2" else torch.ones_like(exact_d[:, -1])
    bad = 0
    entries = 0
    wrong = 0
    hits = 0
    gap = 0.0
    err = 0.0
    per = max(1, (BLOCK_ELEMS // 2) // max(batch * k * x.shape[1], 1))
    for a, b in chunks(len(answers), per):
        group = answers[a:b]
        shaped = [(s, d, i) for s, d, i in group
                  if np.shape(d) == (batch, k) and np.shape(i) == (batch, k)]
        bad += batch * (len(group) - len(shaped))
        entries += batch * k * (len(group) - len(shaped))
        if not shaped:
            continue
        rows = torch.as_tensor(pool_rows([s for s, _, _ in shaped], batch, pool), device=dev)
        ids = torch.as_tensor(np.concatenate([np.asarray(i, np.int64) for _, _, i in shaped]),
                              device=dev)
        dret = torch.as_tensor(np.concatenate([np.asarray(d, np.float64) for _, d, _ in shaped]),
                               device=dev)
        srt = torch.sort(ids, dim=1).values
        ok = ((ids >= 0) & (ids < n)).all(dim=1) & (srt[:, 1:] != srt[:, :-1]).all(dim=1)
        bad += int((~ok).sum())
        entries += int(ids.shape[0]) * k
        rows, ids, dret = rows[ok], ids[ok], dret[ok]
        if rows.numel() == 0:
            continue
        scale = scale_all[rows][:, None]
        td = pair_distances(q[rows], x[ids], metric)
        err = max(err, float(((dret - td).abs() / scale).max()))
        excess = (torch.sort(td, dim=1).values - expected_d[rows]) / scale
        gap = max(gap, float(excess.max().clamp(min=0.0)))
        wrong += int((excess > TIE).sum())
        hits += int((td <= exact_d[rows, -1:] + TIE * scale).sum())
    return {
        "bad_rows": float(bad),
        "topk_gap": gap,
        "wrong_share": wrong / max(entries, 1),
        "dist_err": err,
        "recall": hits / max(entries, 1),
    }
