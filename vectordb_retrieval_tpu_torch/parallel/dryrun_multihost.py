"""Multi-process dryrun: sharded exact search over a ``(dcn, db)`` mesh.

Counterpart of ``scripts/dryrun_multihost.py``. Each worker process is one
"host": it joins the process group (:func:`~vectordb_retrieval_tpu_torch.
parallel.mesh.init_distributed`: gloo on the CPU, NCCL on a card), builds
:func:`~vectordb_retrieval_tpu_torch.parallel.mesh.make_multihost_mesh`
over ``--local-devices`` copies of its device, places its shards of the
database (sharded over both axes) and runs ``sharded_exact_search``: each
process merges its own shards, then one ``all_gather`` of k-wide candidate
lists spans the processes.

Run as coordinator (spawns the workers and stops them all):

    python -m vectordb_retrieval_tpu_torch.parallel.dryrun_multihost \\
        --procs 2 --local-devices 4 --device cpu

``--device`` defaults to the card (``cuda``), one process a card; with
``--procs`` left out that is one process per visible card (a world of one
on a single card).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER_TIMEOUT_S = 150


def worker(args) -> int:
    import numpy as np
    import torch

    from vectordb_retrieval_tpu_torch.parallel.mesh import (
        host_local_rows,
        init_distributed,
        make_multihost_mesh,
    )
    from vectordb_retrieval_tpu_torch.parallel.sharded import (
        shard_database,
        sharded_exact_search,
    )

    torch.set_num_threads(1)
    if args.device == "cuda":
        dev = f"cuda:{args.proc_id % torch.cuda.device_count()}"
        torch.cuda.set_device(dev)
    else:
        dev = "cpu"
    init_distributed(args.coordinator, num_processes=args.procs, process_id=args.proc_id,
                     device=dev)
    import torch.distributed as dist

    try:
        mesh = make_multihost_mesh(devices=[dev] * args.local_devices)
        n, d, k = 256, 16, 5
        rng = np.random.default_rng(0)
        x = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((8, d)).astype(np.float32)
        lo, hi = host_local_rows(n)
        assert hi - lo <= -(-n // args.procs)
        db, n_total = shard_database(x, mesh, axis=("dcn", "db"))
        dd, ii = sharded_exact_search(torch.as_tensor(q, device=dev), db, n_total, k, mesh,
                                      db_axis=("dcn", "db"))
        got_d = np.sort(dd.cpu().numpy(), axis=1)
        full = ((q[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
        exp_d = np.sort(full, axis=1)[:, :k]
        exp_i = np.argsort(full, axis=1, kind="stable")[:, :k]
        max_err = float(np.abs(got_d - exp_d).max())
        ok = bool(np.allclose(got_d, exp_d, rtol=1e-5, atol=1e-5)
                  and np.array_equal(ii.cpu().numpy(), exp_i))
        print(f"proc {args.proc_id}: mesh={dict(mesh.shape)} devices={[str(v) for v in mesh.devices.reshape(-1)]} "
              f"world={dist.get_world_size()} backend={dist.get_backend()} "
              f"max_err={max_err:.2e} ok={ok}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=None,
                    help="worker processes (default: 2 on the CPU, one per visible card)")
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args(argv)

    if args.proc_id is not None:
        return worker(args)
    if args.procs is None:
        if args.device == "cuda":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available; pass --device cpu")
            args.procs = torch.cuda.device_count()
        else:
            args.procs = 2
    with socket.socket() as s:  # a free port for the rendezvous
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_PKG_ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "vectordb_retrieval_tpu_torch.parallel.dryrun_multihost",
             "--proc-id", str(i), "--procs", str(args.procs),
             "--local-devices", str(args.local_devices), "--device", args.device,
             "--coordinator", f"localhost:{port}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for i in range(args.procs)
    ]
    rc = 0
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            for line in out.decode().splitlines():
                if "proc " in line or "ok=" in line or "Error" in line:
                    print(line, flush=True)
            rc |= p.returncode
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rc |= 1
    print("dryrun_multihost", "ok" if rc == 0 else "FAILED", flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
