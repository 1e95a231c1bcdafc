"""Stage profile of the fused probed-blockmin IVF path on the SIFT1M
surrogate.

Builds ``IVF1024,Flat`` (bf16 lists) on the surrogate, then times
cumulative stages of ``ops/ivf._fused_stream``:
  1. coarse probes (``exact_probe_mask``)
  2. + kernel stream (kernel K1, bf16 mode, ``ops/kernels.dist_blockmin``)
  3. + probed blockmin gather + selection
  4. + block rescore
  5. + the top-k of the rescored blocks (full path = ``ivf_flat_search``)
It bears on ``ops/ivf._fused_w`` (the stream's width), the fused stream
and ``_rescore_blocks``.

The counterpart of the JAX package's ``scripts/exp_ivf_fused_profile.py``:
the same options (plus ``--data-dir``, whose ``sift1m_synth`` holds the
surrogate ``scripts.make_sift1m_surrogate`` writes, and ``--device``), the
same build and printed lines, then one ``check`` line
(``scripts/probes.print_check``): whether stage 5's ids equal a separate
``ivf_flat_search`` call's, and its recall@k against the dataset's ground
truth. The JAX script's direct call of ``dist_blockmin_pallas`` is K1's
wrapper here; stage 3 cuts with the port's ``_probed_blocks``, the
tie-free top-k of the search itself (``top_k_smallest_by_id``; the JAX
script inlines a ``top_k_smallest``). Timing: the JAX script chains
``--iters`` passes in one ``jit``; here one untimed pass, then ``--iters``
passes on the device with one synchronise and one copy of the last result
to the host inside the clock (``scripts/probes.timed_passes``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_ivf_fused_profile \\
        [--k 100] [--nprobe 32] [--iters 8] [--b 256] [--data-dir data] \\
        [--device cpu]

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
from vectordb_retrieval_tpu_torch.data.datasets import Dataset
from vectordb_retrieval_tpu_torch.models.factory import FactoryIndexer
from vectordb_retrieval_tpu_torch.ops import ivf as ivfops
from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.scripts.probes import print_check, timed_passes
from vectordb_retrieval_tpu_torch.utils.device import resolve_device


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--data-dir", default="data")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the host)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = Dataset(
        "sift1m", data_dir=args.data_dir,
        options={"subdir": "sift1m_synth", "test_size": args.b,
                 "ground_truth_k": args.k},
        device=device,
    ).load()
    x = ds.train_vectors
    q0 = torch.as_tensor(np.asarray(ds.test_vectors[: args.b], np.float32), device=device)

    idx = FactoryIndexer(
        index_key="IVF1024,Flat", metric="l2", nprobe=args.nprobe, device=device
    )
    t0 = time.time()
    art = idx.build(np.asarray(x), x.shape[1])
    print(f"build {time.time()-t0:.1f}s", flush=True)
    d = art.data
    slot_ids = d["slot_ids"]
    list_vecs = d["list_vecs"]
    coarse = d["centroids"]
    bucket_lists = d["bucket_lists"]
    sqn = d["list_sqnorms"]
    nlist = int(art.metadata["nlist"])
    cum = art.metadata["probe_cum"]
    budget = int(cum[args.nprobe - 1])
    n_bkt, L = slot_ids.shape
    w = ivfops._fused_w(L)
    bpb = L // w
    k = args.k
    fetch_k = k + 8
    nb = min(fetch_k + ivfops._BLOCKMIN_SLACK, 10**9)
    print(f"n_bkt={n_bkt} L={L} w={w} budget={budget} bpb={bpb}")

    pen = torch.where(
        slot_ids.reshape(-1) >= 0, sqn.reshape(-1), float("inf")
    ).reshape(-1, w)
    payload = list_vecs.reshape(n_bkt * L, -1)
    lcent = d["list_centroids"]

    def probes_of(q):
        return ivfops.exact_probe_mask(
            q, coarse, bucket_lists, nlist, args.nprobe, budget,
            list_centroids=lcent,
        )

    def s1(q):
        p, v = probes_of(q)
        return torch.sum(p, 1, dtype=torch.float32) + torch.sum(v, 1)

    def kernel(q):
        return kernels.dist_blockmin(q.to(torch.bfloat16), payload, pen, w=w)

    def s2(q):
        p, v = probes_of(q)
        bm = kernel(q)
        return torch.sum(p, 1, dtype=torch.float32) + bm[:, 0]

    def sel_of(q):
        p, v = probes_of(q)
        return ivfops._probed_blocks(kernel(q), p, n_bkt, bpb, nb, v)

    def s3(q):
        sv, blk = sel_of(q)
        return torch.sum(blk, 1).float() + sv[:, 0]

    def s4(q):
        sv, blk = sel_of(q)
        bvecs = list_vecs.reshape(n_bkt * L // w, w, -1)[blk].float()
        diff = bvecs - q[:, None, None, :]
        cd = torch.sum(diff * diff, dim=-1)
        return torch.amin(cd, dim=(1, 2)) + sv[:, 0]

    def search(q):
        return ivfops.ivf_flat_search(
            q, coarse, slot_ids, list_vecs, sqn, k, budget, metric="l2",
            bucket_lists=bucket_lists, nlist=nlist,
            nprobe_lists=args.nprobe, list_centroids=lcent,
        )

    def s5(q):
        vals, ids = search(q)
        return vals[:, 0] + ids[:, 0].float(), ids

    def time_fn(name, fn):
        out, dt = timed_passes(fn, q0, args.iters, device)
        dt /= args.iters
        print(f"{name:<28s} {dt*1e3:8.2f} ms/pass ({args.b/dt:9.0f} QPS)",
              flush=True)
        return out

    time_fn("1 probes", s1)
    time_fn("2 +kernel", s2)
    time_fn("3 +probed sel", s3)
    time_fn("4 +block rescore", s4)
    ids = time_fn("5 FULL ivf_flat_search", s5)
    ref = search(q0)[1].cpu().numpy()
    gt = np.asarray(ds.ground_truth[: args.b, :k])
    print_check(full_ids_equal=bool(np.array_equal(ids, ref)),
                recall=recall_at_k(gt, ids, k))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
