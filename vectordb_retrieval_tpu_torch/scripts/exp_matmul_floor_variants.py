"""K5's design choices on the card, and K1/K3/K4 against another tree's.

K5 (``csrc/matmul_floor.cu``, ``ops/kernels.matmul_floor``) is built as it
ships and as text variants of its sources (VARIANTS: the cluster size, the
register split between producer and consumers, where the next stage's
split runs, the stage sums without their overlap with the products, the
cluster arrive's release scope, and the consumers alone with every barrier
wait taken out), each with ``nvcc`` and ``kernels.NVCC_FLAGS`` into
``_build/variants/``. Each variant whose results are meant to be right is
held to the plain version at both shapes; then all are timed (CUDA events)
at phase 7d's two shapes, 256 x 100,032 x 384 (w 8) and 256 x 1,000,192 x
128 (w 32), beside K1 f32 on the same inputs, in turns (variants in order,
then in reverse). With ``--parent-csrc`` (another tree's ``csrc/``, e.g.
``git archive`` of the parent commit unpacked under ``_build/``), K1 (f32,
bf16, u8, the pair), K3 and K4 built from it are timed against this
tree's in one process, parent, tree, tree, parent, and each kernel's
ptxas registers and spills are set beside the parent's. A variant only
measures: none ships. Prints one line a number, then one ``check`` line
(``scripts/probes.print_check``).

    python -m vectordb_retrieval_tpu_torch.scripts.exp_matmul_floor_variants \\
        [--variants shipped,cluster1,...] [--reps 20] [--parent-csrc DIR]

``--device`` defaults to the CUDA card and fails without one; the kernels
exist only there.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

import torch

from vectordb_retrieval_tpu_torch.ops import kernels
from vectordb_retrieval_tpu_torch.scripts.probes import print_check
from vectordb_retrieval_tpu_torch.utils.device import resolve_device

SHAPES = ((256, 100_032, 384, 8), (256, 1_000_192, 128, 32))

_STAGE_HEAD = """      wgmma_wait<1>();  // half 0 (and the stage before) done
      add(0, cur.k == 0);
      split_stage(other, next);
      products(other, 0, next);"""
# name -> (whether its results are right, [(file, text, replacement)])
VARIANTS: Dict[str, Tuple[bool, List[Tuple[str, str, str]]]] = {
    "shipped": (True, []),
    "cluster1": (True, [("matmul_floor.cu", "constexpr int CL = 2;", "constexpr int CL = 1;")]),
    "cluster4": (True, [("matmul_floor.cu", "constexpr int CL = 2;", "constexpr int CL = 4;")]),
    "regs56": (True, [("matmul_floor.cu", "PRODUCER_REGS = 40, CONSUMER_REGS = 232",
                       "PRODUCER_REGS = 56, CONSUMER_REGS = 224")]),
    "early_split": (True, [("matmul_floor.cu", _STAGE_HEAD, """      split_stage(other, next);
      wgmma_wait<1>();  // half 0 (and the stage before) done
      add(0, cur.k == 0);
      products(other, 0, next);""")]),
    "no_overlap": (True, [("matmul_floor.cu", _STAGE_HEAD,
                           _STAGE_HEAD.replace("wgmma_wait<1>();", "wgmma_wait<0>();"))]),
    "cluster_release": (True, [("tma.cuh", "mbarrier.arrive.shared::cluster.b64",
                                "mbarrier.arrive.release.cluster.shared::cluster.b64")]),
    "consumers_only": (False, [
        ("matmul_floor.cu", "      mbar_wait(full + 8 * (cur.step % NS), (cur.step / NS) & 1);\n",
         ""),
        ("matmul_floor.cu", "    if (!p.vec || tid == 0) {", "    if (p.B < 0) {"),
        ("matmul_floor.cu", "      if (lane == 0) release(empty + 8 * (cur.step % NS));\n"
         "      add(1, cur.k == 0);\n      products", "      add(1, cur.k == 0);\n      products"),
        ("matmul_floor.cu", "      if (lane == 0) release(empty + 8 * (cur.step % NS));\n"
         "      add(1, cur.k == 0);\n      store", "      add(1, cur.k == 0);\n      store"),
    ]),
}


def variant_sources(name: str, csrc: str = kernels.CSRC_DIR) -> Dict[str, str]:
    """The variant's text of each file of ``csrc`` (every substitution must
    match its file exactly once)."""
    texts = {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc)
             if f.endswith((".cu", ".cuh"))}
    for f, old, new in VARIANTS[name][1]:
        if texts[f].count(old) != 1:
            raise ValueError(f"{name}: {f} holds {texts[f].count(old)} copies of {old!r}")
        texts[f] = texts[f].replace(old, new)
    return texts


def _ptxas(log: str) -> List[str]:
    """Each kernel's registers and spills from nvcc's ``-Xptxas -v`` output,
    one line a kernel (its mangled name, then the numbers)."""
    lines, entry = [], ""
    for ln in log.splitlines():
        if "entry function" in ln:
            entry = ln.split("'")[1]
        elif ("spill" in ln or "registers" in ln) and entry:
            lines.append(f"{entry}: {ln.strip()}")
    return sorted(lines)


def _build(jobs: Dict[str, Tuple[str, str]]) -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """nvcc of each (directory, source) into ``directory/lib<name>.so``, all
    started together; the libraries and the compiler's output."""
    procs = {}
    for name, (d, src) in jobs.items():
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", os.path.join(d, f"lib{name}.so"),
             os.path.join(d, src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln or "Performance" in ln]
        print(f"{name:<28s} {' | '.join(spills[:2])}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(jobs[name][0], f"lib{name}.so"))
        logs[name] = log
    return libs, logs


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _k5_variants(names: List[str], reps: int, out: str, device: torch.device) -> dict:
    jobs = {}
    for name in names:
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for f, text in variant_sources(name).items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        jobs[f"k5_{name}"] = (d, "matmul_floor.cu")
    libs, _ = _build(jobs)
    for lib in libs.values():
        kernels._bind("matmul_floor", lib)
    shipped = kernels._lib("matmul_floor")
    result = {}
    for b, s, d, w in SHAPES:
        g = torch.Generator(device=device).manual_seed(7)
        q = torch.randn((b, d), generator=g, device=device)
        x = torch.randn((s, d), generator=g, device=device)
        pen = torch.zeros((s // w, w), device=device)
        want = kernels.matmul_floor_reference(q, x, w)
        scale = float(want.abs().max())
        key = f"{b}x{s}x{d}/w{w}"
        row = {"rel_err": {}, "ms": {name: 0.0 for name in names}}
        for name in names:
            kernels._LIBS["matmul_floor"] = libs[f"k5_{name}"]
            got = kernels.matmul_floor(q, x, w=w)
            torch.cuda.synchronize()
            if VARIANTS[name][0]:
                row["rel_err"][name] = float((got - want).abs().max()) / scale
        for order in (names, names[::-1]):  # in turns
            for name in order:
                kernels._LIBS["matmul_floor"] = libs[f"k5_{name}"]
                row["ms"][name] += _time_ms(lambda: kernels.matmul_floor(q, x, w=w), reps) / 2
        kernels._LIBS["matmul_floor"] = shipped
        row["ms"]["k1_f32"] = _time_ms(lambda: kernels.dist_blockmin(q, x, pen, w=w), reps)
        row["k1_loop_bound_ms"] = 6.0 * b * s * d / 495e12 * 1e3
        for name, ms in row["ms"].items():
            print(f"{key:<22s} {name:<18s} {ms:8.4f} ms  "
                  f"{row['k1_loop_bound_ms'] / ms:6.1%} of K1's loop bound", flush=True)
        result[key] = row
        del q, x, pen, want
        torch.cuda.empty_cache()
    return result


def _parent_ab(parent_csrc: str, reps: int, out: str, device: torch.device) -> dict:
    names = ("dist_blockmin_tc", "assign", "blockmin")
    d = os.path.join(out, "parent")
    shutil.copytree(parent_csrc, d, dirs_exist_ok=True)
    old, old_logs = _build({n: (d, f"{n}.cu") for n in names})
    for n, lib in old.items():
        kernels._bind(n, lib)
    kernels.build(names)
    new = {n: kernels._LIBS[n] for n in names}
    # every kernel this tree builds has the parent's registers and spills
    ptxas = {}
    for n in names:
        tree, parent = _ptxas(kernels.BUILD_LOG.get(n, "")), _ptxas(old_logs[n])
        ptxas[n] = {"tree_in_parent": bool(tree) and set(tree) <= set(parent),
                    "tree": len(tree), "parent": len(parent)}
        for ln in tree:
            print(f"ptxas {n}: {ln} {'(as the parent)' if ln in parent else '(NEW)'}", flush=True)
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    cases = {}
    for b, s, d_, w in ((256, 100_000, 384, 8), (256, 1_000_192, 128, 32)):
        q, x, pen = randn(b, d_), randn(s, d_), torch.zeros((s // w, w), device=device)
        cases[f"K1 f32 {b}x{s}x{d_} w{w}"] = (
            lambda q=q, x=x, pen=pen, w=w: kernels.dist_blockmin(q, x, pen, w=w))
    q = randn(256, 128)
    xb, pb = randn(1_531_648, 128).to(torch.bfloat16), torch.zeros((47_864, 32), device=device)
    xu = torch.randint(0, 256, (1_134_592, 128), generator=g, device=device, dtype=torch.uint8)
    pu = torch.zeros((35_456, 32), device=device)
    q5, x5 = randn(512, 384), randn(100_320, 384).to(torch.bfloat16)
    p5 = torch.zeros((12_540, 8), device=device)
    pts, cen, q4, x4 = randn(1_000_000, 128), randn(1024, 128), randn(256, 384), randn(100_352, 384)
    cases.update({
        "K1 bf16 256x1531648x128 w32": lambda: kernels.dist_blockmin(q, xb, pb, w=32),
        "K1 u8 256x1134592x128 w32": lambda: kernels.dist_blockmin(q, xu, pu, w=32),
        "K1 pair 512x100320x384 w8": lambda: kernels.dist_blockmin_pair(q5, x5, p5, p5, w=8),
        "K3 1Mx1024x128": lambda: kernels.assign(pts, cen),
        "K4 256x100352x384 w8": lambda: kernels.blockmin(q4, x4, w=8),
    })
    rows = {}
    for name, fn in cases.items():
        ms = {"parent": 0.0, "tree": 0.0}
        for who in ("parent", "tree", "tree", "parent"):
            kernels._LIBS.update(old if who == "parent" else new)
            ms[who] += _time_ms(fn, reps) / 2
        kernels._LIBS.update(new)
        rows[name] = {**ms, "tree_over_parent": ms["tree"] / ms["parent"]}
        print(f"{name:<30s} parent {ms['parent']:8.4f} ms  tree {ms['tree']:8.4f} ms  "
              f"{ms['tree'] / ms['parent'] - 1:+.1%}", flush=True)
    return {"times": rows, "ptxas": ptxas}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent-csrc", default=None,
                    help="another tree's csrc/ to time K1, K3 and K4 against")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; the kernels need one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = args.variants.split(",")
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    out = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    numbers = {"variants": _k5_variants(names, args.reps, out, device)}
    if args.parent_csrc:
        numbers["parent_ab"] = _parent_ab(args.parent_csrc, args.reps, out, device)
    print_check(**numbers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
