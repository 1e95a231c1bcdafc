"""Run one cell of the benchmark once and print its result line.

    python -m retrieval_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last lines of standard error, each number the correctness
comparison reads beside its limit, and as the last line of standard output
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, then ``info`` and, last,
``checks``. Exits with 2, printing no result, without a CUDA card (or
fewer cards than the cell asks for), and with 3 if JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache a run may write lives at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(_ROOT, ".rb_cache", _sub)
os.environ["USE_FLAX"] = "0"  # no library may load JAX on its own


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from retrieval_bench import harness

    need = harness.chips(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"retrieval_bench: the cell needs {need} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"retrieval_bench: loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    print(f"correct {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
