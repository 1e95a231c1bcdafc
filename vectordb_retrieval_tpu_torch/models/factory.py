"""Factory indexer (IVF/PQ/SQ grammar) + the generic ANN searcher.

Counterpart of ``vectordb_retrieval_tpu/models/factory.py``:
``IVF{n},Flat`` (bf16 or f32 lists, optional exact rescore),
``IVF{n},PQ{m}`` (residual PQ, optional per-list rotations:
``pq_rotations`` = a block size or ``'auto'``), ``IVF{n},SQ8``, bare
``PQ{m}`` and ``SQ8``, each optionally behind an ``OPQ{m},`` rotation.
Out-of-core corpora (``np.memmap``, ``BigStore``) upload in chunks, and
``IVF{n},PQ{m}`` / ``IVF{n},SQ8`` without OPQ build fully streaming
(:meth:`FactoryIndexer._build_ivf_stream`: neither host nor device ever
holds the raw corpus). The row-sharded kinds (``ivf_flat_sharded``,
``ivf_pq_sharded``, ``ivf_sq8_sharded``, ``graph_sharded``) come from
``models/sharded.py`` and are searched through ``parallel/``.

``ANNSearcher`` dispatches on artifact kind with runtime params (``nprobe``
from searcher params or artifact metadata; ``efSearch`` for ``graph``
artifacts, ``models/graph.py``; ``lsh_candidate_multiplier``, default
32, for ``binary_lsh`` artifacts, ``models/lsh.py``). Registry aliases keep
the JAX package's YAML configs loadable verbatim: ``FaissFactoryIndexer`` ->
:class:`FactoryIndexer`, ``FaissIVFIndexer`` -> :class:`IVFIndexer`,
``FaissSearcher`` -> :class:`ANNSearcher`. Batches are not padded (the JAX
searcher pads to powers of two only to bound XLA recompiles).
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.data.storage import (
    _read_chunk,
    corpus_to_device,
    is_out_of_core,
    iter_device_chunks,
)
from vectordb_retrieval_tpu_torch.models import graph as graph_models
from vectordb_retrieval_tpu_torch.models import lsh as lsh_models
from vectordb_retrieval_tpu_torch.models.base import (
    BaseIndexer,
    BaseSearcher,
    IndexArtifact,
    check_artifact_device,
    register_indexer,
    register_searcher,
)
from vectordb_retrieval_tpu_torch.ops import distances as dops
from vectordb_retrieval_tpu_torch.ops import ivf as ivfops
from vectordb_retrieval_tpu_torch.ops import pq as pqops
from vectordb_retrieval_tpu_torch.ops import sq as sqops
from vectordb_retrieval_tpu_torch.ops.kmeans import (
    kmeans_assign,
    kmeans_fit,
    training_sample,
)
from vectordb_retrieval_tpu_torch.utils.device import synchronize
from vectordb_retrieval_tpu_torch.utils.profiling import span

_FACTORY_RE = re.compile(
    r"^(?:OPQ(?P<opq>\d+),)?(?:IVF(?P<nlist>\d+),)?(?P<code>Flat|PQ(?P<m>\d+)|SQ8)$"
)


def parse_index_key(index_key: str) -> Dict[str, Any]:
    """Parse the factory grammar into {opq?, nlist?, coding, m?}."""
    m = _FACTORY_RE.match(index_key.strip())
    if not m:
        raise ValueError(
            f"unsupported index_key {index_key!r}; expected "
            "[OPQ{m},][IVF{n},](Flat|PQ{m}|SQ8)"
        )
    out: Dict[str, Any] = {
        "nlist": None, "coding": "flat", "m": None, "opq": None,
    }
    if m.group("opq"):
        out["opq"] = int(m.group("opq"))
    if m.group("nlist"):
        out["nlist"] = int(m.group("nlist"))
    code = m.group("code")
    if code == "Flat":
        out["coding"] = "flat"
    elif code == "SQ8":
        out["coding"] = "sq8"
    else:
        out["coding"] = "pq"
        out["m"] = int(m.group("m"))
    if out["nlist"] is None and out["coding"] == "flat":
        raise ValueError("bare 'Flat' has no quantization; use BruteForceIndexer")
    return out


def _gather_slots(arr: torch.Tensor, slot_ids: np.ndarray) -> torch.Tensor:
    """Gather rows into the bucket layout ``[n_buckets, L, ...]`` (padding
    slots read row 0)."""
    safe = torch.as_tensor(np.where(slot_ids >= 0, slot_ids, 0), device=arr.device)
    return arr[safe.long()]


@register_indexer("FactoryIndexer")
@register_indexer("FaissFactoryIndexer")
class FactoryIndexer(BaseIndexer):
    """Builds quantized artifacts from an ``index_key`` grammar string."""

    def __init__(
        self,
        metric: str = "l2",
        index_key: str = "IVF100,Flat",
        nprobe: int = 10,
        train_iters: int = 20,
        seed: int = 123,
        list_dtype: str = "bf16",
        exact_rescore: bool = False,
        bucket_len: int = 0,
        pq_rotations: Any = 0,
        **params: Any,
    ):
        super().__init__(metric=metric, **params)
        self.index_key = index_key
        self.nprobe = int(nprobe)
        self.train_iters = int(train_iters)
        self.seed = int(seed)
        # bucket-length cap of the bucketed layout (0 = per-coding default:
        # 256 for coded payloads, 2048 for flat lists)
        self.bucket_len = int(bucket_len)
        if list_dtype not in ("bf16", "f32"):
            raise ValueError("list_dtype must be 'bf16' or 'f32'")
        self.list_dtype = list_dtype
        # opt-in: keep the f32 corpus for an exact re-rank of the final
        # candidates of bf16 lists (+1x corpus memory)
        self.exact_rescore = bool(exact_rescore)
        # per-list block-diagonal residual rotations for IVF-PQ: a block
        # size in dims, 0 = off, 'auto' = the held-out MSE A/B decides
        # (_residual_coding); stored as [nlist, d/bs, bs, bs]
        if isinstance(pq_rotations, str) and pq_rotations.lower() == "auto":
            self.pq_rotations: Any = "auto"
        else:
            self.pq_rotations = int(pq_rotations)
        # seconds of the last build by part (the card's queue drained at
        # each part's end)
        self.build_seconds: Dict[str, float] = {}

    # pq_rotations='auto' enables the rotations only where they cut the
    # held-out residual reconstruction MSE by at least this fraction (the
    # JAX package's threshold)
    PQ_ROT_AUTO_GAIN = 0.05

    def _lap(self, part: str) -> None:
        """Close the build part ``part`` on the card's clock."""
        synchronize(self.device)
        now = time.perf_counter()
        self.build_seconds[part] = self.build_seconds.get(part, 0.0) + now - self._t
        self._t = now

    def _residual_coding(
        self,
        residuals: torch.Tensor,
        assignments: torch.Tensor,
        nlist: int,
        m: int,
        meta: Dict[str, Any],
        seed: int,
    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """``(rotations | None, codebooks)`` of the IVF-PQ residual coding,
        resolving ``pq_rotations='auto'`` by :func:`ops.pq.rotation_gain`;
        the decision and the measured gain go to ``meta['pq_rot_auto']``."""
        want = self.pq_rotations
        if want == "auto":
            bs = pqops.auto_rotation_block(int(residuals.shape[1]))
            gain, err_p, err_r, rots, cb_rot = pqops.rotation_gain(
                residuals, assignments, nlist, m, bs,
                seed=seed, iters=self.train_iters,
            )
            self._lap("rotations")
            enabled = gain >= self.PQ_ROT_AUTO_GAIN
            meta["pq_rot_auto"] = {
                "bs": bs,
                "gain": round(float(gain), 4),
                "err_plain": float(err_p),
                "err_rot": float(err_r),
                "threshold": self.PQ_ROT_AUTO_GAIN,
                "enabled": bool(enabled),
            }
            if enabled:
                meta["pq_rot_bs"] = bs
                return rots, cb_rot
        elif want:
            meta["pq_rot_bs"] = int(want)
            out = pqops.train_per_list_rotations(
                residuals, assignments, nlist, m, int(want),
                seed=seed, iters=self.train_iters,
            )
            self._lap("rotations")
            return out
        cb = pqops.pq_train(residuals, m, seed=seed, iters=self.train_iters)
        self._lap("pq_train")
        return None, cb

    def build(self, vectors: np.ndarray, dimension: int) -> IndexArtifact:
        spec = parse_index_key(self.index_key)
        self.build_seconds = {}
        self._t = time.perf_counter()
        if (
            is_out_of_core(vectors)
            and spec["nlist"] is not None
            and spec["coding"] in ("pq", "sq8")
            and not spec["opq"]
        ):
            return self._build_ivf_stream(vectors, spec)
        # memmap / BigStore corpora upload in bounded chunks
        x = corpus_to_device(vectors, device=self.device)
        if self.metric == "cosine":
            x = dops.normalize(x)
        n, d = x.shape
        meta: Dict[str, Any] = {
            "metric": self.metric,
            "dimension": int(d),
            "n_vectors": int(n),
            "normalize_queries": self.metric == "cosine",
            "index_key": self.index_key,
            "nprobe": self.nprobe,
        }
        self._lap("upload")
        rotation = None
        if spec["opq"]:
            # the OPQ rotation, learned on a training sample; the corpus
            # (and every query) is searched as x @ R
            sample = training_sample(n, 256, self.seed ^ 0x09)
            train_x = x if sample is None else x[sample.to(x.device)]
            rotation, _ = pqops.opq_train(
                train_x, spec["opq"], seed=self.seed, iters=self.train_iters
            )
            x = x @ rotation
            meta["opq_m"] = spec["opq"]
            self._lap("opq")
        if spec["nlist"] is None:
            art = self._build_flat_coded(x, spec, meta)
        else:
            art = self._build_ivf(x, spec, meta)
        if rotation is not None:
            art.data["opq_rotation"] = rotation
        return art

    # -- flat-coded (PQ{m} / SQ8 without IVF) ---------------------------
    def _build_flat_coded(
        self, x: torch.Tensor, spec: Dict[str, Any], meta: Dict[str, Any]
    ) -> IndexArtifact:
        if spec["coding"] == "pq":
            m = spec["m"]
            sample = training_sample(x.shape[0], 256, self.seed)
            train_x = x if sample is None else x[sample.to(x.device)]
            codebooks = pqops.pq_train(
                train_x, m, seed=self.seed, iters=self.train_iters
            )
            self._lap("pq_train")
            codes = pqops.pq_encode(x, codebooks)
            data = {
                "codes": codes,
                "codebooks": codebooks,
                "code_sqnorms": pqops.pq_code_sqnorms(codes, codebooks),
            }
            meta["m"] = m
            self._lap("encode")
            return IndexArtifact("pq", data, meta)
        vmin, step = sqops.sq_train(x)
        codes = sqops.sq_encode(x, vmin, step)
        sqn = dops.sq_norms(sqops.sq_decode(codes, vmin, step))
        data = {"codes": codes, "vmin": vmin, "step": step, "code_sqnorms": sqn}
        self._lap("encode")
        return IndexArtifact("sq8", data, meta)

    # -- out-of-core IVF (streamed build, compressed payload) ------------
    def _build_ivf_stream(
        self, store, spec: Dict[str, Any], chunk_rows: int = 262_144
    ) -> IndexArtifact:
        """IVF-PQ / IVF-SQ8 build over an out-of-core corpus.

        The quantizers (coarse k-means; PQ codebooks or SQ ranges) train on
        an evenly spaced sample of 4,096-row blocks, ``max(32 nlist,
        65,536)`` rows; then the corpus streams through the device one
        chunk at a time for assignment (K3) and encoding, and only the
        codes (4-32x smaller than the rows), their squared norms and the
        assignment are kept, on the device. Peak host memory is O(chunk),
        device memory O(chunk + codes). The bucket layout is the JAX
        package's (``build_bucketed_lists`` at its defaults).
        """
        n, d = (int(s) for s in store.shape)
        dev = self.device
        nlist = min(spec["nlist"], n)
        meta: Dict[str, Any] = {
            "metric": self.metric,
            "dimension": d,
            "n_vectors": n,
            "normalize_queries": self.metric == "cosine",
            "index_key": self.index_key,
            "nprobe": self.nprobe,
            "built_streaming": True,
        }

        def prep(rows: torch.Tensor) -> torch.Tensor:
            return dops.normalize(rows) if self.metric == "cosine" else rows

        target = min(n, max(nlist * 32, 65_536))
        block = 4096
        stride = max(1, n // max(1, -(-target // block)))
        sample = prep(torch.as_tensor(np.concatenate(
            [_read_chunk(store, s, min(s + block, n)) for s in range(0, n, stride)]
        )[:target], device=dev))
        self._lap("sample")
        centroids, _ = kmeans_fit(sample, nlist, seed=self.seed, iters=self.train_iters)
        self._lap("coarse_kmeans")
        rots = None
        if spec["coding"] == "pq":
            m = spec["m"]
            meta["m"] = m
            s_assign = kmeans_assign(sample, centroids)
            rots, codebooks = self._residual_coding(
                sample - centroids[s_assign], s_assign, nlist, m, meta, seed=self.seed + 1,
            )
            code_w = m
        else:
            vmin, step = sqops.sq_train(sample)
            code_w = d
            self._lap("sq_train")
        del sample

        codes = torch.empty((n, code_w), dtype=torch.uint8, device=dev)
        sqn = torch.empty((n,), dtype=torch.float32, device=dev)
        assign = torch.empty((n,), dtype=torch.int64, device=dev)
        for start, rows in iter_device_chunks(store, chunk_rows, dev):
            stop = start + rows.shape[0]
            rows = prep(rows)
            a = kmeans_assign(rows, centroids)
            if spec["coding"] == "pq":
                residuals = rows - centroids[a]
                if rots is not None:
                    c = pqops.pq_encode_rotated(residuals, a, rots, codebooks)
                else:
                    c = pqops.pq_encode(residuals, codebooks)
                sn = pqops.pq_code_sqnorms(c, codebooks)
            else:
                c = sqops.sq_encode(rows, vmin, step)
                sn = dops.sq_norms(sqops.sq_decode(c, vmin, step))
            codes[start:stop], sqn[start:stop], assign[start:stop] = c, sn, a
            del rows
        self._lap("encode")

        slot_ids_np, bucket_lists_np, pad_ratio = ivfops.build_bucketed_lists(
            assign.cpu().numpy(), nlist
        )
        del assign
        meta.update(
            {
                "nlist": int(nlist),
                "n_buckets": int(slot_ids_np.shape[0]),
                "pad_ratio": pad_ratio,
                "max_list_len": int(slot_ids_np.shape[1]),
                "probe_cum": [
                    int(v) for v in ivfops.probe_budget_cum(bucket_lists_np, nlist)
                ],
            }
        )
        data: Dict[str, Any] = {
            "centroids": ivfops.coarse_table(centroids, bucket_lists_np),
            "list_centroids": centroids,  # scatter-free exact-probe table
            "bucket_lists": torch.as_tensor(bucket_lists_np, device=dev),
            "slot_ids": torch.as_tensor(slot_ids_np, device=dev),
            "list_codes": _gather_slots(codes, slot_ids_np),
            "list_sqnorms": _gather_slots(sqn, slot_ids_np),
        }
        del codes, sqn
        if spec["coding"] == "pq":
            data["codebooks"] = codebooks
            if rots is not None:
                data["list_rotations"] = rots
            kind = "ivf_pq"
        else:
            data["vmin"] = vmin
            data["step"] = step
            kind = "ivf_sq8"
        self._lap("layout")
        return IndexArtifact(kind, data, meta)

    # -- IVF variants ----------------------------------------------------
    def _build_ivf(
        self, x: torch.Tensor, spec: Dict[str, Any], meta: Dict[str, Any]
    ) -> IndexArtifact:
        n, d = x.shape
        dev = x.device
        nlist = min(spec["nlist"], n)
        sample = training_sample(n, nlist, self.seed)
        train_x = x if sample is None else x[sample.to(dev)]
        centroids, _ = kmeans_fit(
            train_x, nlist, seed=self.seed, iters=self.train_iters
        )
        assign_dev = kmeans_assign(x, centroids)
        assignments = assign_dev.cpu().numpy()
        self._lap("coarse_kmeans")
        # coded payloads keep short buckets (padding costs codes and decode
        # work); flat lists long ones
        cap = self.bucket_len or (2048 if spec["coding"] == "flat" else 256)
        slot_ids_np, bucket_lists_np, pad_ratio = ivfops.build_bucketed_lists(
            assignments, nlist, target_len_cap=cap
        )
        meta.update(
            {
                "nlist": int(nlist),
                "n_buckets": int(slot_ids_np.shape[0]),
                "pad_ratio": pad_ratio,
                "max_list_len": int(slot_ids_np.shape[1]),
                "probe_cum": [
                    int(v)
                    for v in ivfops.probe_budget_cum(bucket_lists_np, nlist)
                ],
            }
        )
        data: Dict[str, Any] = {
            "centroids": ivfops.coarse_table(centroids, bucket_lists_np),
            "list_centroids": centroids,  # scatter-free exact-probe table
            "bucket_lists": torch.as_tensor(bucket_lists_np, device=dev),
            "slot_ids": torch.as_tensor(slot_ids_np, device=dev),
        }

        if spec["coding"] == "flat":
            meta["exact_rescore"] = bool(self.exact_rescore)
            list_vecs = _gather_slots(x, slot_ids_np)
            data["list_sqnorms"] = dops.sq_norms(list_vecs)
            if self.list_dtype == "bf16":
                # bf16 lists halve the payload the search streams
                data["list_vecs"] = list_vecs.to(torch.bfloat16)
                del list_vecs
                if self.exact_rescore:
                    data["full_vectors"] = x
            else:
                data["list_vecs"] = list_vecs
            kind = "ivf_flat"
        elif spec["coding"] == "pq":
            m = spec["m"]
            meta["m"] = m
            residuals = x - centroids[assign_dev]
            r_sample = training_sample(n, 256, self.seed + 1)
            if r_sample is None:
                tr_r, tr_a = residuals, assign_dev
            else:
                r_sample = r_sample.to(dev)
                tr_r, tr_a = residuals[r_sample], assign_dev[r_sample]
            rots, codebooks = self._residual_coding(
                tr_r, tr_a, nlist, m, meta, seed=self.seed
            )
            if rots is not None:
                codes = pqops.pq_encode_rotated(residuals, assign_dev, rots, codebooks)
                data["list_rotations"] = rots
            else:
                codes = pqops.pq_encode(residuals, codebooks)
            del residuals
            sqn = pqops.pq_code_sqnorms(codes, codebooks)
            data["codebooks"] = codebooks
            data["list_codes"] = _gather_slots(codes, slot_ids_np)
            data["list_sqnorms"] = _gather_slots(sqn, slot_ids_np)
            kind = "ivf_pq"
        else:  # sq8
            vmin, step = sqops.sq_train(x)
            codes = sqops.sq_encode(x, vmin, step)
            sqn = dops.sq_norms(sqops.sq_decode(codes, vmin, step))
            data["vmin"] = vmin
            data["step"] = step
            data["list_codes"] = _gather_slots(codes, slot_ids_np)
            data["list_sqnorms"] = _gather_slots(sqn, slot_ids_np)
            kind = "ivf_sq8"
        self._lap("encode")
        return IndexArtifact(kind, data, meta)


@register_indexer("IVFIndexer")
@register_indexer("FaissIVFIndexer")
class IVFIndexer(FactoryIndexer):
    """Back-compat alias: ``index_type`` -> ``index_key``."""

    def __init__(self, metric: str = "l2", index_type: str = "IVF100,Flat",
                 **params: Any):
        params.pop("index_key", None)
        super().__init__(metric=metric, index_key=index_type, **params)


@register_searcher("ANNSearcher")
@register_searcher("FaissSearcher")
class ANNSearcher(BaseSearcher):
    """Serves flat/quantized/IVF/graph artifacts; runtime ``nprobe`` and
    ``efSearch`` overrides."""

    SUPPORTED = (
        "flat", "pq", "sq8", "ivf_flat", "ivf_pq", "ivf_sq8", "binary_lsh", "graph",
        "ivf_flat_sharded", "ivf_pq_sharded", "ivf_sq8_sharded", "graph_sharded",
    )

    def attach(self, artifact: IndexArtifact) -> None:
        if artifact.kind not in self.SUPPORTED:
            raise ValueError(
                f"ANNSearcher cannot serve artifact kind {artifact.kind!r}"
            )
        if artifact.kind.endswith("_sharded"):
            if not hasattr(artifact, "mesh"):
                # loaded from disk: place the stacks over the searcher's devices
                from vectordb_retrieval_tpu_torch.models.sharded import reshard_artifact

                reshard_artifact(artifact, self.devices)
        else:
            check_artifact_device(artifact, self.device)
        self.artifact = artifact

    def _nprobe(self) -> int:
        """Probe budget in buckets: ``probe_cum[nprobe - 1]`` (the sum of the
        nprobe LARGEST per-list bucket counts) covers every bucket of the
        nprobe nearest lists under any skew."""
        nprobe = int(
            self.params.get("nprobe", self.artifact.metadata.get("nprobe", 10))
        )
        meta = self.artifact.metadata
        nlist = int(meta.get("nlist", 0))
        n_buckets = int(meta.get("n_buckets", nlist))
        if nlist and n_buckets > nlist:
            cum = meta.get("probe_cum")
            if cum is None:
                bl = self.artifact.data.get("bucket_lists")
                if bl is not None:  # legacy artifact: derive once, cache
                    cum = [
                        int(v)
                        for v in ivfops.probe_budget_cum(bl.cpu().numpy(), nlist)
                    ]
                    meta["probe_cum"] = cum
            if cum is not None:
                nprobe = int(cum[min(nprobe, len(cum)) - 1])
            else:
                nprobe = -(-nprobe * n_buckets // nlist)
        return max(1, min(nprobe, n_buckets or nprobe))

    def _probe_kwargs(self) -> dict:
        """The reference's "probe the nprobe nearest LISTS" semantics for
        bucketed layouts (``ops/ivf.exact_probe_mask``); pass
        ``nprobe_semantics: buckets`` for the generous bucket budget."""
        meta = self.artifact.metadata
        nlist = int(meta.get("nlist", 0))
        n_buckets = int(meta.get("n_buckets", nlist))
        semantics = str(
            self.params.get(
                "nprobe_semantics", meta.get("nprobe_semantics", "lists")
            )
        )
        bl = self.artifact.data.get("bucket_lists")
        if (
            semantics != "lists" or not nlist or n_buckets <= nlist
            or bl is None
        ):
            return {}
        raw = int(self.params.get("nprobe", meta.get("nprobe", 10)))
        out = {
            "bucket_lists": bl,
            "nlist": nlist,
            "nprobe_lists": max(1, min(raw, nlist)),
        }
        lc = self.artifact.data.get("list_centroids")
        if lc is not None:  # scatter-free list-distance table
            out["list_centroids"] = lc
        return out

    def _sharded_probe_lists(self) -> int:
        """The reference's nprobe semantics for the sharded family: each
        shard probes its own ``nprobe`` nearest LISTS (FAISS IndexShards'
        per-shard ``index.nprobe``). 0 = the generous bucket budget
        (``nprobe_semantics: buckets``, or no ``bucket_lists``)."""
        meta = self.artifact.metadata
        semantics = str(
            self.params.get("nprobe_semantics", meta.get("nprobe_semantics", "lists"))
        )
        if semantics != "lists" or "bucket_lists" not in self.artifact.data:
            return 0
        raw = int(self.params.get("nprobe", meta.get("nprobe", 10)))
        return max(1, min(raw, int(meta.get("nlist", 1))))

    def _score_metric(self) -> str:
        metric = self.artifact.metadata.get("metric", self.metric)
        return "ip" if metric in ("ip", "cosine") else "l2"

    def device_kernel(self, q: torch.Tensor, k: int):
        """Device queries in, device ``(dists, ids)`` out; no host copy."""
        art = self.artifact
        meta = art.metadata
        if meta.get("normalize_queries"):
            q = dops.normalize(q)
        rotation = art.data.get("opq_rotation")
        if rotation is not None:  # OPQ: queries follow the corpus
            q = q @ rotation
        metric = self._score_metric()
        eff_k = min(k, meta["n_vectors"])
        kind = art.kind
        d = art.data
        if kind == "flat":
            dists, ids = dops.exact_search(
                q, d["vectors"], eff_k, metric=metric,
                db_sqnorms=d.get("sqnorms"), device=self.device,
            )
            row_ids = d.get("row_ids")
            if row_ids is not None:  # mutable snapshot: stable-id mapping
                ids = torch.where(ids >= 0, row_ids[ids.clamp(min=0)].long(), -1)
        elif kind == "pq":
            dists, ids = pqops.pq_search(
                q, d["codes"], d["codebooks"], d["code_sqnorms"], eff_k,
                metric=metric,
            )
        elif kind == "sq8":
            dists, ids = sqops.sq_search(
                q, d["codes"], d["vmin"], d["step"], d["code_sqnorms"], eff_k,
                metric=metric,
            )
        elif kind == "ivf_flat":
            dists, ids = ivfops.ivf_flat_search(
                q, d["centroids"], d["slot_ids"], d["list_vecs"],
                d["list_sqnorms"], eff_k, self._nprobe(), metric=metric,
                full_vectors=d.get("full_vectors"), **self._probe_kwargs(),
            )
        elif kind == "ivf_pq":
            rot_kw = {}
            if d.get("list_rotations") is not None:
                rot_kw = {"list_rotations": d["list_rotations"],
                          "rot_bucket_lists": d["bucket_lists"]}
            dists, ids = ivfops.ivf_pq_search(
                q, d["centroids"], d["slot_ids"], d["list_codes"],
                d["list_sqnorms"], d["codebooks"], eff_k, self._nprobe(),
                metric=metric, **self._probe_kwargs(), **rot_kw,
            )
        elif kind == "graph":
            ef = int(self.params.get("efSearch", meta.get("efSearch", 100)))
            dists, ids = graph_models.graph_artifact_search(art, q, eff_k, metric, ef)
        elif kind.endswith("_sharded"):
            dists, ids = self._sharded_search(q, eff_k, metric)
        elif kind == "binary_lsh":
            dists, ids = lsh_models.binary_lsh_search(
                art, q, eff_k, metric,
                float(self.params.get("lsh_candidate_multiplier", 32.0)),
            )
        else:  # ivf_sq8
            dists, ids = ivfops.ivf_sq_search(
                q, d["centroids"], d["slot_ids"], d["list_codes"],
                d["list_sqnorms"], d["vmin"], d["step"], eff_k, self._nprobe(),
                metric=metric, **self._probe_kwargs(),
            )
        return dists, ids

    def _sharded_search(self, q: torch.Tensor, k: int, metric: str):
        """A ``*_sharded`` artifact's search over its mesh."""
        from vectordb_retrieval_tpu_torch import parallel as par

        art = self.artifact
        meta, d, mesh = art.metadata, art.data, art.mesh
        if art.kind == "graph_sharded":
            ef = int(self.params.get("efSearch", meta.get("efSearch", 100)))
            if meta.get("mode") == "block":
                efb, expand, iters = graph_models.block_geometry(
                    int(meta["n_blocks"]), ef, k, block_len=int(meta.get("block_len", 128)))
                return par.sharded_block_graph_search(
                    q, d, k, mesh, efb=efb, expand=expand, iters=iters, metric=metric)
            return par.sharded_graph_search(
                q, d, meta["n_vectors"], k, mesh, ef=max(int(ef * 1.25), k + 8, 16),
                metric=metric)
        kw = {"nlist": int(meta.get("nlist", 0)), "nprobe_lists": self._sharded_probe_lists()}
        if art.kind == "ivf_flat_sharded":
            return par.sharded_ivf_flat_search(q, d, k, self._nprobe(), mesh, metric=metric, **kw)
        return par.sharded_ivf_coded_search(
            q, d, k, self._nprobe(), mesh,
            coding="pq" if art.kind == "ivf_pq_sharded" else "sq8", metric=metric, **kw)

    def device_batch_search(self, queries: np.ndarray, k: int):
        """Dispatch without waiting: returns (dists_dev, ids_dev, n_rows)."""
        if self.artifact is None:
            raise RuntimeError("searcher not attached")
        with span("vrt.h2d"):
            q = torch.as_tensor(
                np.ascontiguousarray(queries, dtype=np.float32), device=self.device
            )
        with span("vrt.search"):
            dists, ids = self.device_kernel(q, k)
        return dists, ids, q.shape[0]

    def batch_search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        dists, ids, _ = self.device_batch_search(queries, k)
        with span("vrt.d2h"):
            out_d = dists.cpu().numpy()
            out_i = ids.cpu().numpy().astype(np.int64)
            if out_d.shape[1] < k:
                pad = k - out_d.shape[1]
                out_d = np.pad(out_d, ((0, 0), (0, pad)), constant_values=np.inf)
                out_i = np.pad(out_i, ((0, 0), (0, pad)), constant_values=-1)
        return out_d, out_i

    def estimated_ops_per_query(self, n_database: int) -> int:
        if self.artifact is None:
            return n_database
        meta = self.artifact.metadata
        if self.artifact.kind.startswith("ivf"):
            return int(
                meta.get("n_buckets", meta.get("nlist", 0))
                + self._nprobe() * meta.get("max_list_len", 0)
            )
        if self.artifact.kind == "graph":
            ef_search = int(self.params.get("efSearch", meta.get("efSearch", 100)))
            if meta.get("mode") == "block":
                _, expand, iters = graph_models.block_geometry(
                    int(meta["n_blocks"]), ef_search, 10,
                    block_len=int(meta.get("block_len", 128)),
                )
                return int(meta["n_blocks"]) + int(
                    expand * iters * meta.get("block_len", 0)
                )
            degree = int(meta.get("degree", 32) or 32)
            n = int(meta.get("n_vectors", n_database))
            _, expand, _, iters = graph_models.beam_geometry(n, degree, ef_search, 10)
            return int(
                meta.get("n_entry", 0) or min(2048, max(16, n // 10))
            ) + int(iters * expand * degree)
        return int(n_database)
