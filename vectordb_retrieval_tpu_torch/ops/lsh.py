"""LSH compute: projection hashing, table-vote counting, Hamming scan.

Counterpart of ``vectordb_retrieval_tpu/ops/lsh.py`` (no TPU kernel there:
matmuls, XOR, ``population_count`` and ``top_k`` in plain ``jnp``):

  * sign-hash keys (cosine) and E2LSH floor-hash keys (l2), one int32 per
    vector and table, from one product with the projections;
  * candidates by table-collision votes, ``votes[b, n] = #{t : key_q[b, t]
    == key_x[n, t]}``, then an exact rerank;
  * binary hyperplane codes packed into 32-bit words, candidates by XOR +
    popcount, and the dense rerank of every row within a Hamming radius.

Every candidate cut is one top-k over int64 keys (the score, then the row
id), so equal scores are kept in ascending row id, as the JAX package's
scans keep them (``jax.lax.top_k`` prefers the lower index and each scan
puts the earlier chunk's best first), and the card and the host keep the
same rows. Scans go over row chunks sized so that no ``[B, chunk, W]`` or
``[B, chunk, T]`` intermediate exceeds ``INTERMEDIATE_BYTES``; their results
do not depend on the chunk.

32-bit words are held as int32 (the same bits as the JAX package's uint32:
torch's uint32 has no shifts on the CPU); unsigned 32-bit arithmetic (the
E2LSH mix, packing, popcount) runs in int64 masked to 32 bits. Hash
projections are f32 products (TF32 off) on every device; the JAX package
takes them at DEFAULT precision, f32 on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vectordb_retrieval_tpu_torch.ops import distances as dops

MIX_PRIME = 2654435761  # Knuth multiplicative mix
_MASK32 = 0xFFFFFFFF
# the largest intermediate of a scan step, in bytes
INTERMEDIATE_BYTES = 512 << 20


def seeded_generator(seed: int) -> torch.Generator:
    """A CPU generator: the same draws whatever device the index lives on."""
    return torch.Generator(device="cpu").manual_seed(int(seed))


def make_projections(
    seed: int, num_tables: int, hash_size: int, dim: int, device=None
) -> torch.Tensor:
    """Gaussian projection tensor ``[T, d, H]`` f32."""
    proj = torch.randn((num_tables, dim, hash_size), generator=seeded_generator(seed))
    return proj.to(device)


def make_offsets(
    seed: int, num_tables: int, hash_size: int, width: float, device=None
) -> torch.Tensor:
    """E2LSH offsets ``[T, H]``, uniform in ``[0, width)``."""
    u = torch.rand((num_tables, hash_size), generator=seeded_generator(seed ^ 0xE2))
    return (u * float(width)).to(device)


def chunk_rows(per_row_bytes: int, n: int, budget: int = INTERMEDIATE_BYTES) -> int:
    """Rows a step may take so that a ``per_row_bytes``-per-row
    intermediate stays within ``budget``."""
    return max(1, min(n, budget // max(per_row_bytes, 1)))


def _project(x: torch.Tensor, projections: torch.Tensor) -> torch.Tensor:
    """``einsum("nd,tdh->nth")`` as one f32 product: ``[N, T, H]``."""
    t, d, h = projections.shape
    flat = projections.permute(1, 0, 2).reshape(d, t * h)
    return torch.matmul(x, flat).reshape(x.shape[0], t, h)


def _to_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2^32)`` -> int32 with the same 32 bits."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def sign_keys(x: torch.Tensor, projections: torch.Tensor) -> torch.Tensor:
    """Cosine sign-hash keys ``[N, T]`` int32: bit-packed ``sign(x @ R_t)``."""
    h = projections.shape[2]
    t = projections.shape[0]
    out = torch.empty((x.shape[0], t), dtype=torch.int32, device=x.device)
    pow2 = torch.pow(2, torch.arange(h, device=x.device, dtype=torch.int64))
    step = chunk_rows(t * h * 8, x.shape[0])
    for s in range(0, x.shape[0], step):
        bits = (_project(x[s : s + step], projections) > 0).long()
        out[s : s + step] = torch.sum(bits * pow2, dim=2).to(torch.int32)
    return out


def mix_cells(cells: torch.Tensor) -> torch.Tensor:
    """The E2LSH secondary hash of int32 lattice cells ``[N, T, H]``:
    ``acc = acc * MIX_PRIME ^ uint32(cell)`` over H, in uint32 arithmetic
    (wrapping at 32 bits), returned as int32 ``[N, T]``."""
    u = cells.long() & _MASK32
    acc = torch.zeros(u.shape[:2], dtype=torch.int64, device=u.device)
    for i in range(u.shape[2]):
        # acc * MIX_PRIME mod 2^32 from 16-bit halves: no product reaches 2^63
        lo, hi = acc & 0xFFFF, acc >> 16
        prod = (lo * MIX_PRIME + (((hi * MIX_PRIME) & 0xFFFF) << 16)) & _MASK32
        acc = prod ^ u[:, :, i]
    return _to_int32(acc)


def e2lsh_keys(
    x: torch.Tensor, projections: torch.Tensor, offsets: torch.Tensor, width: float
) -> torch.Tensor:
    """E2LSH floor-hash keys ``[N, T]``: ``floor((x @ R + b) / w)`` mixed to
    one int32 per table (:func:`mix_cells`)."""
    t, _, h = projections.shape
    out = torch.empty((x.shape[0], t), dtype=torch.int32, device=x.device)
    step = chunk_rows(t * h * 16, x.shape[0])
    for s in range(0, x.shape[0], step):
        proj = _project(x[s : s + step], projections)
        cells = torch.floor((proj + offsets[None]) / width).to(torch.int32)
        out[s : s + step] = mix_cells(cells)
    return out


def _keep_smallest(best: Optional[torch.Tensor], key: torch.Tensor, n: int) -> torch.Tensor:
    """Running cut: the ``n`` smallest int64 keys of ``best`` and ``key``
    (distinct keys, so the cut has no ties), ascending."""
    cat = key if best is None else torch.cat([best, key], dim=1)
    return torch.topk(cat, min(n, cat.shape[1]), dim=1, largest=False, sorted=True).values


def _row_ids(start: int, stop: int, device) -> torch.Tensor:
    return torch.arange(start, stop, device=device, dtype=torch.int64)[None, :]


def vote_candidates(
    query_keys: torch.Tensor,  # [B, T] int32
    db_keys: torch.Tensor,  # [N, T] int32
    n_candidates: int,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top candidates by table-collision votes: ``(votes [B, C] int32,
    ids [B, C] int64)``, descending votes, equal votes in ascending id.
    Zero-vote entries mean no collision; the caller masks them."""
    b, t = query_keys.shape
    n = db_keys.shape[0]
    chunk = chunk or chunk_rows(b * (t + 16), n)
    best = None
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        votes = torch.sum(query_keys[:, None, :] == db_keys[None, s:e, :], dim=2)
        best = _keep_smallest(best, (-votes << 32) | _row_ids(s, e, votes.device), n_candidates)
    return (-(best >> 32)).to(torch.int32), best & _MASK32


def rerank(
    queries: torch.Tensor,  # [B, d]
    database: torch.Tensor,  # [N, d]
    cand_ids: torch.Tensor,  # [B, C], -1 = invalid
    k: int,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact rescoring of gathered candidates -> top-k ``(dists, ids)``;
    equal distances keep the earlier candidate. l2 is the
    cancellation-free difference sum, ip the negated dot."""
    dist = dops.rescore(queries, database, cand_ids, metric)
    kk = min(k, cand_ids.shape[1])
    cols = torch.arange(cand_ids.shape[1], device=dist.device)[None, :]
    d, sel = dops.top_k_smallest_by_id(dist, cols, kk)
    ids = torch.gather(cand_ids, 1, sel).long()
    return d, torch.where(torch.isfinite(d), ids, -1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack bool ``[N, nbits]`` into 32-bit words ``[N, ceil(nbits/32)]``
    (int32 holding the bits of the JAX package's uint32 words; bit j of a
    word is column ``32 w + j``)."""
    n, nbits = bits.shape
    pad = (-nbits) % 32
    b = torch.nn.functional.pad(bits.long(), (0, pad)).reshape(n, -1, 32)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    return _to_int32(torch.sum(b << shifts, dim=2))


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 or int64 holding 32 bits): a
    SWAR count in int64, masked after every shift. Returns int64."""
    x = words.long() & _MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _hamming(query_words: torch.Tensor, db_words: torch.Tensor) -> torch.Tensor:
    """Hamming distances ``[B, C]`` int64 between ``[B, W]`` and ``[C, W]``."""
    return popcount32(query_words[:, None, :] ^ db_words[None, :, :]).sum(dim=2)


def _hamming_chunk(b: int, w: int, n: int, chunk: Optional[int]) -> int:
    return chunk or chunk_rows(b * w * 8, n)


def hamming_candidates(
    query_words: torch.Tensor,  # [B, W] int32
    db_words: torch.Tensor,  # [N, W] int32
    n_candidates: int,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``n_candidates`` rows of smallest Hamming distance: ``(ham [B, C]
    int64, ids [B, C] int64)``, ascending, equal distances in ascending id."""
    b, w = query_words.shape
    n = db_words.shape[0]
    chunk = _hamming_chunk(b, w, n, chunk)
    best = None
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        ham = _hamming(query_words, db_words[s:e])
        best = _keep_smallest(best, (ham << 32) | _row_ids(s, e, ham.device), n_candidates)
    return best >> 32, best & _MASK32


def hamming_threshold_rerank(
    queries: torch.Tensor,  # [B, d] f32
    query_words: torch.Tensor,  # [B, W] int32
    database: torch.Tensor,  # [N, d] f32
    db_words: torch.Tensor,  # [N, W] int32
    kth: torch.Tensor,  # [B, 1] per-query Hamming radius
    k: int,
    metric: str = "l2",
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather-free exact rerank of every row within a Hamming radius:
    candidates ``{i : hamming(q, x_i) <= kth[q]}`` (the gather path's set
    plus every row tied at the radius), scored in one dense pass over the
    corpus: ``||q||^2 + ||x||^2 - 2 q.x`` for l2, ``-q.x`` for ip, the
    products in f32 (the JAX package's ``Precision.HIGHEST``). Equal
    distances keep the lower row id."""
    b = queries.shape[0]
    n = database.shape[0]
    w = query_words.shape[1]
    chunk = _hamming_chunk(b, w, n, chunk)
    q_sqn = torch.sum(queries * queries, dim=1, keepdim=True)
    inf = torch.tensor(float("inf"), device=queries.device)
    best_d = best_i = None
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        xc = database[s:e]
        keep = _hamming(query_words, db_words[s:e]) <= kth
        dots = torch.matmul(queries, xc.T)
        if metric == "l2":
            dist = q_sqn + torch.sum(xc * xc, dim=1)[None, :] - 2.0 * dots
        else:
            dist = -dots
        dist = torch.where(keep, dist, inf)
        ids = _row_ids(s, e, dist.device).expand(b, -1)
        if best_d is not None:
            dist = torch.cat([best_d, dist], dim=1)
            ids = torch.cat([best_i, ids], dim=1)
        best_d, sel = dops.top_k_smallest_by_id(dist, ids, min(k, dist.shape[1]))
        best_i = torch.gather(ids, 1, sel)
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)
