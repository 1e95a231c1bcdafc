"""The JAX package's numbers behind ``chip_smoke.py``'s calibration phase,
computed on the host CPU (and, beside them, the port's builds there).

Each subcommand prints one JSON line per row (recall@20):

  glove      ``scripts/calibrate_glove_surrogate.py``'s ``run_setting()`` on
             each of its five settings (20k x 50, the defaults first):
             ``GLOVE_JAX_DEFAULTS`` is the first line;
  manifold   ``scripts/calibrate_manifold.py``'s PQ64 and IVF256,PQ64
             (nprobe 48) rows at 100k x 384 for each ``--point-scale`` of
             ``--intrinsic-dim``, built with each indexer seed of
             ``--seeds`` (the FactoryIndexer's default is 123) by
             ``--package``: ``jax`` or ``port`` (the port on the host, with
             its own draws). Other seeds show how far each package's
             builds move with their k-means draws.

The MS MARCO numbers are the JAX script's own ``--quick --platform cpu``
run, and the manifold's seed-123 ones its ``--platform cpu`` grid.

    JAX_PLATFORMS=cpu python tests/jax_calibration_reference.py manifold \\
        --seeds 123,1,2,3 [--point-scale 0.35,0.5,0.7] [--package port]
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GLOVE_SETTINGS = [
    {},
    {"anisotropy": 0.4, "point_scale": 1.0},
    {"anisotropy": 0.2, "point_scale": 1.0, "child_scale": 1.0},
    {"anisotropy": 0.0, "point_scale": 1.3, "child_scale": 1.1},
    {"anisotropy": 0.0, "point_scale": 1.5, "child_scale": 1.3},
]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _factory_recall(x, q, gt, key, seed, package, nprobe=None):
    from vectordb_retrieval_tpu.bench.metrics import recall_at_k

    if package == "jax":
        from vectordb_retrieval_tpu.models.factory import ANNSearcher, FactoryIndexer

        kw = {}
    else:
        from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher, FactoryIndexer

        kw = {"device": "cpu"}
    art = FactoryIndexer(metric="l2", index_key=key, seed=seed, **kw).build(x, x.shape[1])
    s = ANNSearcher(metric="l2", **kw, **({"nprobe": nprobe} if nprobe else {}))
    s.attach(art)
    _, ids = s.batch_search(q, 20)
    return round(float(recall_at_k(gt, np.asarray(ids), 20)), 4)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("glove", "manifold"))
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--seeds", default="123")
    ap.add_argument("--intrinsic-dim", type=int, default=12)
    ap.add_argument("--point-scale", default="0.35,0.5,0.7")
    ap.add_argument("--package", default="jax", choices=("jax", "port"))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.what == "glove":
        mod = _jax_script("calibrate_glove_surrogate")
        for s in GLOVE_SETTINGS:
            t0 = time.time()
            print(json.dumps({"setting": s, "recall": mod.run_setting(**s),
                              "seconds": time.time() - t0}), flush=True)
        return 0
    from vectordb_retrieval_tpu.data.datasets import Dataset

    for ps in (float(v) for v in args.point_scale.split(",")):
        ds = Dataset("manifold", options={
            "dim": 384, "train_limit": args.n, "test_size": 256, "ground_truth_k": 20,
            "n_patches": 256, "intrinsic_dim": args.intrinsic_dim, "point_scale": ps,
            "use_cache": False}).load()
        x, q = np.asarray(ds.train_vectors), np.asarray(ds.test_vectors)
        gt = np.asarray(ds.ground_truth[:, :20])
        for seed in (int(v) for v in args.seeds.split(",")):
            print(json.dumps({
                "intrinsic_dim": args.intrinsic_dim, "point_scale": ps, "seed": seed,
                "package": args.package,
                "pq": _factory_recall(x, q, gt, "PQ64", seed, args.package),
                "ivf_pq": _factory_recall(x, q, gt, "IVF256,PQ64", seed, args.package, 48),
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
