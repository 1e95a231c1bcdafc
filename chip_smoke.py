#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (or a few) and raising (exit code != 0)
on failure:

  1. device      - fail at once without CUDA; the card's name and power limit
  2. build       - compile every CUDA source of the port from ``csrc/`` (one
                   nvcc per source, all started together); registers, spills
                   and shared memory per kernel; the HGMMA (wgmma)
                   instructions in the SASS of each library: every kernel
                   runs on the tensor cores (libdist_blockmin_tc.so K1,
                   libassign.so K3, libslab_dots.so K2, libblockmin.so K4,
                   libmatmul_floor.so K5;
                   none in any of them fails the run; libblock_rescore.so,
                   K6 and the IVF bf16 rescore, runs on the CUDA cores and
                   is not counted; the registers and spills of each of its
                   instantiations on a line of their own). Beside nvcc, ``make
                   -C native`` (the host IO library) and the port's
                   scripts.make_sift1m_surrogate at its defaults (1M x
                   128, 1,024 queries, seed 20) into _smoke_out/sift1m_synth;
                   then the surrogate as the sift1m loader reads it: the
                   reader (native), seconds to generate and read, the native
                   read bit-identical to NumPy's
  3. kernels     - each kernel against its plain PyTorch version on the card:
                   dist_blockmin in its f32, bf16 and u8 modes (flagship,
                   ragged and 10%-dead shapes; every mode over every
                   combination of B 7/64/300, d 17/50/64/96/128/384 and w
                   1/8/32/128 with S off the 128-row tile, bf16 and u8 also
                   as dist_blockmin_pair); the per-product precision line
                   (K1 f32, blockmin and assign, one nonzero product an
                   output, against float64 within 2e-6 relative) and the
                   depth line (K1 f32 and blockmin at d 128 and 384 on unit
                   vectors against float64, beside the plain version;
                   reported, not gated), assign (the IVF1024
                   k-means sample and corpus, ragged shapes over every
                   query-tile residency, a tie case, PQ training's
                   65,536 x 256 at d = dsub 2 and 6), slab_dots (the two
                   graph rows' wave shapes, the surrogate's with half its
                   pops on one slab, f32 shapes, ragged cases with repeated
                   and end ids, and out-of-range ids that must give NaN
                   rows; each with the grouping's spread) and
                   blockmin (the JAX oracle's shape, w = 32, a ragged B over
                   3 query tiles, three tiles at w = 128, and exact search's
                   flagship padded with rows of 1e6; no path of the system
                   calls it, so these checks are its launches) and
                   matmul_floor (K5: phase 7d's two shapes, 256 x 100,032 x
                   384 at w 8 and 256 x 1,000,192 x 128 at w 32, a ragged B
                   and d, w 8-128 with S off the 128-row tile, d % 4 != 0
                   at w 32 and a payload view one element into its buffer
                   (both on the kernel's masked loads); each also against
                   float64) and block_rescore (K6: the two exact cells'
                   shapes, integer rows equal to the plain version, float
                   rows within 1e-6 of its largest score, d 3-2048, w
                   8-128, single-float loads) and ivf_block_rescore (the
                   IVF bf16 rescore: sift1m.ivf_flat's shape and nine
                   more, dead slots, unprobed pairs and shared blocks,
                   the same tolerances, d 32-768, w 8-128, single loads)
  4. exact path  - the port's BenchmarkRunner (exact row: BruteForceIndexer +
                   LinearSearcher) on 100k x 384 random data, l2 and cosine;
                   ground truth, timed batched search, recall@20 == 1.0, the
                   launch counts of K1 and K6 (100k rows lie above the
                   dense cut: stage 3 is K6, at least once), and a float64
                   spot check of the ground truth
  5. IVF path    - the BenchmarkRunner's IVF-Flat, IVF-SQ8, IVF-PQ
                   (IVF1024,PQ32 np64), exact and E2LSH (12 tables, hash 18,
                   width 256, candidate_multiplier 8, with the fallback:
                   the rows it answered by exact search reported) rows of
                   configs/sift1m.yaml on the SIFT1M surrogate (1M x 128,
                   l2, top-100, 256 queries), each held to the JAX
                   package's committed recall@100 less 0.03 (exact 1.0,
                   with a float64 spot check of its ground truth), and the
                   IVF-Flat and
                   IVF-SQ8 rows at the MS MARCO MiniLM shape (100k x 384,
                   cosine, top-20; configs/benchmark_config.yaml msmarco):
                   per row, assign launched in the build and
                   dist_blockmin_bf16 / _u8 in the timed search (IVF-PQ:
                   bf16 over its decoded lists), recall, build time, index
                   memory; each PQ build's assign launches at d = dsub
                   (at least one), its build seconds by part. The
                   msmarco_surrogate configuration's ivf_pq, pq (PQ192) and
                   pq_refconfig (PQ64) rows must reach the JAX package's
                   committed recall less 0.03; the manifold configuration
                   (the JAX package's rotations A/B: IVF256,PQ64 np48 on
                   100k x 384, l2, top-20, pq_rotations 0 and 'auto') must
                   enable the rotations and gain >= 0.10 recall@20. Then the
                   card against the host (64 queries searched with the plain
                   versions on the CPU), and build_only -> retrieve_only
                   round trips
  5b. graph path - the BenchmarkRunner's hnsw rows: configs/msmarco_surrogate
                   .yaml on the msmarco_surrogate corpus (100k x 384, cosine,
                   top-20, auto mode: must build block mode, recall@20 >=
                   0.90), configs/sift1m.yaml's block-mode row in the SIFT1M
                   surrogate configuration, and a node-mode row added to
                   the MS MARCO-shape one; build time, index memory, recall
                   and slab_dots launches per row (the block rows must launch
                   it). The graph rows join the card-against-host check
                   (ids >= 0.99) and the block-mode MS MARCO row the round
                   trip
  5d. LSH path  - the BenchmarkRunner's faiss_lsh rows (BinaryLSHIndexer,
                   512 bits, top-20) of configs/round5_faiss_lsh_refresh.yaml
                   (random 20k x 64, multiplier 128; glove50_surrogate 20k x
                   50, multiplier 512) and ..._sift.yaml (the SIFT1M
                   surrogate, multiplier 64), each held to the JAX package's
                   committed recall@20 less 0.03, with its build time, index
                   memory, rerank path (gather or dense threshold) and QPS
  5c. cover tree - the BenchmarkRunner's four CoverTreeV2_2 rows of
                   configs/covertree_refresh.yaml: msmarco_surrogate (100k x
                   384 unit vectors, cosine, top-20, 512 queries in one batch,
                   repeat 16; auto descent: must take the block walk and
                   launch dist_blockmin_pair once per batch), random (20k
                   x 64, l2, top-20, 256 queries), glove50_surrogate (20k x
                   50, l2, top-20) and sift1m on the SIFT1M surrogate (1M x
                   128, l2, top-100, repeat 8); recall == 1.0, build
                   time by part, nodes, depths, w, index bytes, ndis, overflowed
                   queries. Then, on the first row's artifact, the block walk
                   against the stream walk; a forced fallback (a 40k-row tree
                   at err_c = 10: flagged, answered by exact search through
                   dist_blockmin f32, still exact); both rows joining the
                   card-against-host check (the host runs the block walk on
                   the plain versions) and the first row a round trip.
                   The card against the host covers every row of 5-5d: PQ
                   rows modulo identical reconstructions, the SIFT
                   surrogate's rows modulo exact distance ties (integer
                   rows), LSH rows at ids >= 0.99 and recall within 0.005
                   (16 queries for the 1M-row Hamming scan, 64 elsewhere)
  5e. serving   - MutableFlatIndex at the MS MARCO MiniLM shape (random 100k x
                   384, cosine: the scan's dense branch) and on the SIFT1M
                   surrogate (1M x 128, l2, 16 adds of 62,500: 8 streamed
                   chunks), each from the default capacity: searches at top
                   20 and 100 held to exact search over the live rows
                   (modulo exact distance ties), 30 % deleted (compaction),
                   filtered searches (10 % of live ids, 1,000 ids) held to
                   exact search over the allowed rows, 100k rows re-added
                   (ids from next_id), save -> load (ids identical) and the
                   snapshot to ANNSearcher; MutableIVFIndex(nlist 1024,
                   nprobe 32) built over a seeded random half of the
                   surrogate, the other half added in 10 batches (bucket
                   growth), 20 % deleted: recall@100 >= the committed
                   IVF1024,Flat np32 row less 0.03, filtered answers only
                   allowed live ids, save -> load and the snapshot (full
                   probe) modulo ties; each index's QPS (256-query batches,
                   unfiltered and filtered), device ms by stage and route,
                   add / delete rates, compaction seconds; every sequence
                   replayed on a host index (64 queries; the IVF one loaded
                   from a save made right after the card's build) and held
                   to the card at >= 99.9 % modulo distance classes
  5f. out of core - python -m vectordb_retrieval_tpu_torch.bench.validate_
                   bigcorpus in a fresh process at its defaults (4M x 128
                   random, storage: memmap, streamed ground truth, the
                   streamed IVF1024,SQ8 build, nprobe 128, k 20), started by
                   a launcher made before this process grows: the growth
                   of peak RSS over the start-up's (torch, its CUDA
                   libraries, the context, the kernels) under the corpus
                   size, the absolute peak printed, recall@20 >= the JAX package's
                   committed 0.5158 less 0.03, built_streaming; then here
                   the chunked upload's GB/s, the streamed ground truth of
                   64 queries against a resident exact search, and the
                   streamed build again under the launch capture; then the
                   SIFT surrogate written to a BigStore in chunks and its
                   hnsw block row stream-built: recall@100 within 0.05 of
                   the in-memory row
  5g. sharded   - the row-sharded family with every shard on the card, on
                   the SIFT1M surrogate (256 queries, top-100, l2), after
                   the throughput phases: the BenchmarkRunner's
                   ShardedIVFIndexer rows IVF256,Flat np8, IVF256,SQ8 np16,
                   IVF256,PQ32 np16 and the ShardedGraphIndexer row (auto:
                   block mode) over db4, and IVF128 over db8, each held to
                   configs/sift1m.yaml's committed recall@100 less 0.03;
                   exact search over db4, db8, q2 x db4, db1 and (dcn, db4)
                   with the NCCL process group as a world of one, the db4
                   IVF-Flat artifact at full probe, each equal to the
                   single-device exact search modulo exact distance ties;
                   the db4 IVF-Flat and graph artifacts against the host
                   and through save -> load -> reshard; ShardedMutableFlat
                   on (replica 2, db 2) through the serving sequence (10
                   adds, a 30 % delete, filters, re-adds; each search
                   equal to exact search over its allowed live rows);
                   ShardedMutableIVF(nlist 1024, nprobe 32 a shard) over
                   db4 built on a seeded half and grown by adds of the
                   rest, 20 % deleted: recall@100 and all-probe
                   self-queries (distance 0, never a deleted id). Each
                   row: build seconds by part, index bytes, the route each
                   shard took, one primed batch's device ms split into the
                   shards' searches, the merge and the rest, QPS with ids
                   on the host, beside the unsharded row's numbers; over
                   db4, each kernel mode at each per-shard shape (K1 f32 /
                   bf16 / u8 and K2 in the timed searches, K3 in the
                   builds) timed on its last launch's inputs beside its
                   plain version, one library call and the card's bound
     In 4, 5, 5b, 5c, 5d, 5e, 5f and 5g every kernel launch of the main path is also held
     against its plain version on the very inputs it was launched with (the
     last launch of each kernel mode, shape and stage: ground truth, each
     build's k-means sample and corpus with its centroids, each timed
     search; in 5c the pair on both of the block walk's pens), after the launch
     counts are read
  6. throughput  - exact search QPS at the flagship shape (100k x 384, l2,
                   top-20, batches of 256; the workload and clock of
                   vectordb_retrieval_tpu_torch/flagship.py) and at 1M x 128
                   (w = 32); each IVF
                   row's QPS and its per-batch device time by stage (IVF-PQ:
                   the decode of every list; coarse probe, K1, probed
                   selection, rescore, rest); the assignment at 1M x 1024 x
                   128 and one Lloyd iteration there (assign, centroid
                   update), and at PQ training's 65,536 x 256 x dsub (dsub
                   2, 4, 6); each graph row's QPS and
                   per-batch device time by stage (block beam: entry scan
                   and seed, per wave pop, slab_dots, merge, push; node
                   beam: seed, per iteration, rescore), slab_dots on every
                   wave's inputs once under set_sync_debug_mode("error")
                   with the grouping's spread; the SIFT surrogate's LSH
                   rows: QPS and per-batch device time by stage (binary:
                   query hashing, Hamming scan, threshold rerank; E2LSH:
                   hashing, votes, gather rerank, exact search of the rows
                   left short); the cover tree's
                   first row: QPS and per-batch device time by stage (the K1
                   pair launch, descent, selection, rescore, overflow read)
                   beside the host clock, and K1 bf16 (one pen) and the pair
                   at its shape; each
                   kernel's time beside its plain version, one library call
                   and the card's bound (K1 f32, blockmin and assign: the
                   bound of their 3xTF32 route, and the FP32 bound beside
                   it); K5 at phase 7d's two shapes beside K1 f32 on
                   the same inputs (K1 less K5: what K1 loses to the card's
                   product loop, epilogue included), its bound that of the
                   function (the S/w rows it reads), its library call the
                   strided product x[::w] @ q.T, the bound of K1's main
                   loop (every row) as k1_loop_bound_ms, the shares of both
                   bounds, and PR 17's K5 times as earlier_ms
                   and K6 at the benchmark's two exact cells' shapes on the
                   port's surrogates of their data and the blocks exact
                   search selects there: its time, the plain version's,
                   its bound (the distinct selected blocks once), the
                   distinct share and the bound were every pair's block read;
                   the IVF bf16 rescore on the SIFT surrogate's IVF-Flat
                   row (sift1m.ivf_flat's shape) and the blocks its stages
                   select, checked there and one element off alignment,
                   timed beside its plain version (the gathered chain it
                   replaced) and both bounds
  7. entry points - the port's CLIs as subprocesses with no --device (the
                   card is their default): the flagship (its JSON line beside
                   phase 6's QPS for the same workload), then together
                   scripts.run_full_benchmark on the smoke config (no row
                   error, exact recall 1.0, the four roofline keys on every
                   row, numbers in the summary's TFLOP/s and GB/s columns),
                   main and scripts.run_experiment on configs/default.yaml,
                   scripts.parameter_sweep on configs/sweep_example.yaml (6
                   combinations), scripts.compare_algorithms on the smoke
                   config (2 runs, every pair's tests) and
                   --create-config; then phase 4's exact row (100k x 384,
                   l2): its counted work at least K1 f32's formula, and one
                   exact-search batch counted alike on the card and the host
  7b. calibration - the port's calibration and data-making tools, each
                   in its own subprocess with no --device, all at once, at
                   the JAX scripts' full sizes, each line with the card's
                   name, power limit and seconds: scripts.calibrate_glove_
                   surrogate (five settings, 20k x 50; the defaults row
                   within 0.03 of the JAX package's run_setting() on a
                   host CPU, best reported), scripts.calibrate_msmarco_
                   surrogate --quick (100k x 384; each row within 0.03 of
                   the JAX script's --quick on a host CPU), scripts.
                   calibrate_manifold (the nine-point grid at 100k x 384,
                   reported; its intrinsic_dim 12 points again with the JAX
                   package's k-means draws, each within 0.03 of the JAX
                   script's), scripts.exp_manifold_rotations with the JAX
                   package's draws (100k, both regimes: six recalls within
                   0.03 and both gains within 0.05 of rotations_ab.json,
                   rot_enabled and auto's decision equal to the record's),
                   scripts.exp_binary_lsh_tune (random and
                   glove50_surrogate at 512 bits over the record's
                   multipliers, within 0.03 of recall_frontier.json, QPS
                   printed) and scripts.prepare_msmarco (TSVs written here,
                   synthetic embed: the .npy shapes). Each subprocess sets
                   the launch counts to 0 before its tool and reads them
                   after, then holds its launches against their plain
                   versions; K1 f32 / bf16 / u8, K3 and K2 must each launch
                   at least once. Every gate is read before a failure
                   fails the run
  7c. probes    - the port's research probes the same way, all at once at
                   the JAX scripts' full sizes: scripts.exp_lsh_frontier
                   (the SIFT1M surrogate, 1M x 128, 256 queries, top-100,
                   13 settings) with its own projections (reported) and
                   with the JAX package's draws (the median kth-NN angle
                   within 0.5 deg of 38.4, r within 1 % of 337.9, each
                   recall@100 within 0.03 of round3_lsh_frontier/
                   frontier_sift1m_tpu.log), scripts.exp_covertree_hard (both walks,
                   recall@20 1.0 but where float32 ties at rank 20 allow
                   a miss), scripts.exp_glove_ceiling (in-degree-0
                   0 at rev M and 2M, rev M at saturation within 0.03 of
                   0.995), scripts.exp_glove_geometry (18 points; at ef 125
                   iters 4 rev 2M within 0.03 of 0.9840 and M of 0.9727),
                   scripts.exp_block_geometry (18 points, reported; its K2
                   f32 waves at L = 256, d = 384 must be among the checked
                   launches) and scripts.exp_manifold_structure (four rows,
                   reported). K1 f32 / bf16 / u8, the pair, K3 and K2 must
                   each launch at least once
  7d. tuning    - the port's tuning probes, the same child body each, ONE AT
                   A TIME in one subprocess (their product is a time; one
                   process start for all; the card synchronised, the
                   allocator's cache emptied and its peak reset between
                   runs, and a CUDA error that breaks the context named as
                   the cause of every later run's failure), at the JAX
                   scripts' default
                   sizes: the exact path's block width (w 8-128 at
                   100k x 384 and 1M x 128), width x slack and width x
                   repeats at the flagship shape, batch 256 against 512,
                   the flagship's components, the 1M stage split, one- and
                   two-level block selection; the IVF fused stream's stages
                   (IVF1024,Flat on the SIFT surrogate), its tail and its
                   rescore formulations; both cover-tree walks at 1M (the
                   SIFT surrogate), the stream walk's profile (msmarco
                   surrogate), stage costs (1.2M x 128) and per-iteration
                   costs; then the last thirteen: K1 f32 against its matmul
                   floor (K5) and by width, at 100k x 384 (w 8) and again at
                   1M x 128 (w 32); the 1M exact path's selections; the IVF
                   rescore's block gather against K2; K1 by width at the
                   flagship; K2's two wave shapes; the flagship stream of 96
                   and 192 batches; the node beam's parts, its ablation, its
                   settings and its neighbour tables (with the JAX package's
                   k-means draws, TUNING_JAX_DRAWS: their gates read recall);
                   the selection primitives' costs. Each probe's last line is
                   its ``check``; the gates (TUNING_GATES) are read for all
                   twenty-eight runs before a failure fails the run. K1 f32 /
                   bf16, the pair, K3, K2 and K5 must each launch at least
                   once
  8. the kernels line, the nvidia-smi line, and last the result line.

Imports nothing of JAX. Writes its YAML and the runner's outputs under
``_smoke_out/`` of the checkout (git-ignored).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "_smoke_out")

# H100 SXM published peaks (NVIDIA data sheet, 700 W): FP32 outside the
# tensor cores, dense bf16 and TF32 on the tensor cores, and HBM3
# bandwidth. The bound of a kernel is the larger of its operations over the
# peak of their type and its bytes over the bandwidth. dist_blockmin's
# bf16/u8 modes do a bf16 product on the tensor cores; its f32 mode,
# blockmin and assign do three TF32 products (3xTF32) for each f32 product;
# slab_dots does three bf16 products (a three-piece split of the query) on
# bf16 slabs and 3xTF32 on f32 slabs.
FP32_PEAK_FLOPS = 67e12
BF16_PEAK_FLOPS = 989e12
TF32_PEAK_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

# Kernel vs plain version: both are f32 sums of <= 384 f32-class products
# (K1 f32 and blockmin: 3xTF32, each product within ~1e-6 relative), taken
# in another order (the tensor cores' vs cuBLAS's), so they differ by a few
# f32 roundings of the largest partial sums; 1e-5 of the largest |score|
# bounds that with a wide margin.
KERNEL_REL_TOL = 1e-5
# One product an output (d = 4, three columns zero): the 3xTF32 route's own
# error, <= 3 x 2^-22 of the product plus f32 rounding, against float64.
# A bf16x3 split would reach ~1.5e-5, plain TF32 ~1e-3.
PRODUCT_REL_TOL = 2e-6
# The bf16/u8 modes (and the pair) vs their plain version: both form exact
# bf16 products and sum them in f32, the kernel on the tensor cores in
# another order and with their own rounding of the partial sums, so they
# differ by a few f32 roundings of sums of <= 384 products: the same 1e-5
# bound holds.
# assign vs its plain version: ids agree on >= 99.9 % (a point whose two
# nearest centroids tie to f32 rounding may go either way), minimum
# distances within 1e-5 of the largest (f32 sums in another order).
ASSIGN_MIN_AGREE = 0.999
# blockmin vs its plain version: both form ||q||^2 + ||x||^2 - 2 q.x with
# full-f32 products summed in another order, so they differ by f32
# roundings of the largest terms: 1e-5 of the largest ||q||^2 + ||x||^2.
# Ground truth vs float64: f32 rounding of a 384-term distance sum.
GT_REL_TOL = 1e-5
# Card against host: sorted ids agree on >= 99.9 % of entries (a coarse
# probe or a final rank may flip where two distances tie to f32 rounding);
# distances within 1e-5 of the largest (exact f32 rescoring sums taken in
# another order on each device).
HOST_MIN_AGREE = 0.999
HOST_REL_TOL = 1e-5
# Graph rows: a beam pops the nearest frontier entries, so where two
# entries tie to matmul rounding the card and the host may walk on through
# different blocks; ids agree on >= 99 %, distances are compared on the
# queries whose id sets agree.
GRAPH_HOST_MIN_AGREE = 0.99
# LSH rows: a key is a floor or a sign of an f32 product, which the card
# and the host sum in another order, so a value near a cell or sign edge
# may hash otherwise and bring other candidates; ids agree on >= 99 %,
# recall within 0.005, distances compared on the queries whose id sets
# agree.
LSH_HOST_MIN_AGREE = 0.99
LSH_HOST_RECALL_TOL = 0.005
# the MS MARCO surrogate's hnsw row must reach this recall@20 (the JAX
# package recorded 0.9869 at the same parameters)
GRAPH_MIN_RECALL = 0.90
# The surrogate's PQ rows (512 queries, recall@20) must reach the JAX
# package's committed recall for the same row less 0.03
# (benchmark_results/round5_fused_k20/msmarco_surrogate_20260820_093335:
# ivf_pq IVF256,PQ64 np48 0.7263, pq_refconfig PQ64 0.7062). PQ192 has no
# committed 512-query number (its 0.8453 was a 256-query probe): its floor
# is that run's PQ128 row, 0.7750, less 0.03, since PQ192 codes each row
# at least as finely.
PQ_RECALL_FLOORS = {"ivf_pq": 0.7263 - 0.03, "pq": 0.7750 - 0.03,
                    "pq_refconfig": 0.7062 - 0.03}
# The manifold A/B (benchmark_results/round5_rotations_ab: plain 0.5604,
# auto 0.7854, gain 0.6877): 'auto' must enable the rotations and beat the
# plain row's recall@20 by this much.
ROT_AB_MIN_RECALL_GAIN = 0.10
KSUB = 256  # PQ codes a subspace: the k-means K of every PQ training

BATCH = 256
TOPK = 20
SEED = 7
DEV = "cuda"

_LINES = []


def emit(obj) -> None:
    line = json.dumps(obj)
    _LINES.append(line)
    print(line, flush=True)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


# ~50 ms of GPU cycles: long enough for the host to queue every timed call
# behind it, so the events see device time, not the host's launch rate
_PRIME_CYCLES = 100_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3, prime: bool = False) -> float:
    """Mean device milliseconds per call, from CUDA events around ``reps``
    calls after ``warmup`` calls. ``prime`` first queues a sleep kernel, so
    a stage of many small kernels is timed on the device and not at the
    host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prime:
        torch.cuda._sleep(_PRIME_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---- 1. device ---------------------------------------------------------


def phase_device():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({
        "phase": "device", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": card,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return card


# ---- 2. build ----------------------------------------------------------


SIFT_SUBDIR = "sift1m_synth"
SIFT_DIR = os.path.join(OUT_DIR, SIFT_SUBDIR)
# the SIFT1M surrogate writer's defaults
# (vectordb_retrieval_tpu_torch/scripts/make_sift1m_surrogate.py): base rows
# and query rows
SIFT_ROWS = 1_000_000
SIFT_QUERY_ROWS = 1024


def _start_host_work() -> dict:
    """Host work that runs beside nvcc: ``make -C native`` (the host IO
    library the sift1m loader reads with) and the port's SIFT1M surrogate
    writer (``python -m vectordb_retrieval_tpu_torch.scripts.
    make_sift1m_surrogate``) at its defaults (1M base rows, 1,024 queries,
    seed 20; NumPy only) into ``_smoke_out/sift1m_synth/``."""
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    return {
        "t0": t0,
        "make": subprocess.Popen(["make", "-C", os.path.join(REPO, "native")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "surrogate": subprocess.Popen(
            [sys.executable, "-m", "vectordb_retrieval_tpu_torch.scripts.make_sift1m_surrogate",
             "--n", str(SIFT_ROWS), "--queries", str(SIFT_QUERY_ROWS), "--seed", "20",
             "--out", SIFT_DIR],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
    }


def _finish_host_work(work: dict) -> dict:
    """Wait for both processes; a failure of either fails the run."""
    out = {}
    for name in ("make", "surrogate"):
        log, _ = work[name].communicate(timeout=600)
        out[name] = {"rc": work[name].returncode, "seconds": time.perf_counter() - work["t0"],
                     "log_tail": log.strip().splitlines()[-1:] if log.strip() else []}
        if work[name].returncode != 0:
            raise AssertionError(f"{name} failed (rc {work[name].returncode}):\n{log}")
    return out


def _stop_host_work(work: dict) -> None:
    for name in ("make", "surrogate"):
        if work[name].poll() is None:
            work[name].kill()
            work[name].wait()


def phase_build(work: dict) -> dict:
    """Build every source; each library of K1-K5 (their kernels run on the
    tensor cores) must hold HGMMA (wgmma) instructions in its SASS (K6 runs
    on the CUDA cores: CUDA_CORE_SOURCES). Its ptxas lines: registers, spills and any wgmma that ptxas
    serialized. The host work of ``work`` runs beside it; returns its
    outcome."""
    from vectordb_retrieval_tpu_torch.ops import kernels

    secs = kernels.build()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "entry function" in ln
               or "Performance Loss" in ln]
        for name, log in kernels.BUILD_LOG.items()
    }
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    hgmma = {}
    for name in (n for n in kernels.KERNEL_SOURCES if n not in CUDA_CORE_SOURCES):
        sass = subprocess.run([cuobjdump, "-sass", kernels._lib_path(name)],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        hgmma[name] = sum("HGMMA" in ln for ln in sass.splitlines())
    host = _finish_host_work(work)
    emit({"phase": "build", "kernels": list(kernels.KERNEL_SOURCES),
          "seconds": secs, "ptxas": ptxas, "hgmma": hgmma, "host_work": host})
    emit({"phase": "block_rescore_registers",
          **_rescore_registers(kernels.BUILD_LOG.get("block_rescore", ""))})
    for name, n in hgmma.items():
        if n < 1:
            raise AssertionError(f"lib{name}.so holds no HGMMA instruction")
    return host


def _rescore_registers(log: str) -> dict:
    """Registers and spill bytes of every instantiation in
    ``libblock_rescore.so``'s ptxas output, by kernel: K6 f32
    (``block_rescore_kernel``) and the IVF bf16 rescore
    (``ivf_block_rescore_kernel``); their template arguments as the mangled
    name gives them. Empty where the library was found already built."""
    import re

    out = {"k6": {}, "ivf_block_rescore": {}}
    fn = None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            fn = m.group(1)
            continue
        if fn is None or "block_rescore_kernel" not in fn:
            continue
        kind = "ivf_block_rescore" if "ivf_block_rescore_kernel" in fn else "k6"
        args = re.search(r"kernelI(.*?)EEv", fn)
        entry = out[kind].setdefault(args.group(1) if args else fn, {})
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if regs:
            entry["registers"] = int(regs.group(1))
        if spill:
            entry["spill_stores"], entry["spill_loads"] = map(int, spill.groups())
    return out


def phase_sift_surrogate(host: dict) -> None:
    """The SIFT1M surrogate as the sift1m loader reads it: which .fvecs
    reader (the native library or NumPy), the seconds to generate and to
    read, and the native read bit-identical to NumPy's parse."""
    import numpy as np

    from vectordb_retrieval_tpu_torch.data import datasets, native_io

    reader = "native" if native_io.available() else "numpy"
    base = os.path.join(SIFT_DIR, "sift_base.fvecs")
    t0 = time.perf_counter()
    x = datasets.read_fvecs(base)
    q = datasets.read_fvecs(os.path.join(SIFT_DIR, "sift_query.fvecs"))
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_np = datasets._read_vecs_numpy(base, None, np.float32)
    numpy_s = time.perf_counter() - t0
    with open(os.path.join(SIFT_DIR, "PROVENANCE.json")) as f:
        provenance = json.load(f)
    ok = (reader == "native" and x.shape == (SIFT_ROWS, 128) and q.shape == (SIFT_QUERY_ROWS, 128)
          and x.tobytes() == x_np.tobytes())
    emit({"phase": "sift_surrogate", "dir": os.path.relpath(SIFT_DIR, REPO),
          "generate_seconds": host["surrogate"]["seconds"], "reader": reader,
          "read_seconds": read_s, "numpy_read_seconds": numpy_s,
          "base": list(x.shape), "queries": list(q.shape), "provenance": provenance,
          "native_equals_numpy": x.tobytes() == x_np.tobytes(),
          "zero_fraction": float((x[:65_536] == 0).mean()), "ok": ok})
    if not ok:
        raise AssertionError(f"SIFT surrogate: reader {reader}, shapes {x.shape} {q.shape}")


# ---- 3. kernel vs plain version ----------------------------------------


# (B, N, d, w, share of dead slots); N is padded to S % w == 0 with dead
# (+inf pen) rows, so (7, 1000, 17, 16) has a partly dead last block
K1_SHAPES = (
    (256, 100_000, 384, 8, 0.0),
    (256, 1_000_000, 128, 32, 0.0),
    (7, 1_000, 17, 16, 0.0),
    (24, 8_192, 96, 16, 0.1),
)
# the bf16/u8 modes' ragged and 10%-dead shapes; the main path's own
# inputs of every mode are checked in phases 4, 5 and 5c (check_launched)
K1_MODE_SHAPES = (
    (7, 1_000, 17, 16, 0.0),
    (24, 8_192, 96, 16, 0.1),
)
# the tensor-core kernel's tile edges, every combination, in both modes, one
# pen and the pair: B over 1-3 query tiles of 128; N = 1000 + 37 w rows
# padded to S % w == 0, so S is no multiple of the 128-row payload tile
# (but for w = 128); d from the masked-load widths (17, 50) to the copied
# ones, resident (<= 256) and streamed queries; w reduced in registers
# (1, 8, 16, 32), across lanes (64, 128); 10 % dead slots and three whole dead
# blocks
K1_TC_B = (7, 64, 300)
K1_TC_D = (17, 50, 64, 96, 128, 384)
K1_TC_W = (1, 8, 16, 32, 64, 128)
# (N points, K centroids, d): the IVF1024 k-means sample (1024 x 256
# points) and corpus at the SIFT1M shape, a ragged shape, a tie case with
# duplicated centroids, and PQ training's subspaces (the 65,536-row sample,
# 256 codes, d = dsub 2 and 6: masked loads, d % 4 != 0); every build's own
# sample, corpus and centroids, each PQ subspace width once, are checked in
# phase 5 (check_launched)
K3_SHAPES = (
    (262_144, 1024, 128, False),
    (1_000_000, 1024, 128, False),
    (1030, 16, 16, False),
    (5000, 300, 40, True),
    (65_536, KSUB, 2, False),
    (65_536, KSUB, 6, False),
)
# PQ training's K3 shapes timed in phase 6: [65,536, 256, dsub]
K3_DSUB = (2, 4, 6)
# (B, W, L, d, Nb, slab dtype, share of pops on slab 0): the MS MARCO
# surrogate row's wave (512 queries x 96 popped slabs of 128 x 384) and the
# SIFT-shape row's (256 x 62 slabs of 256 x 128), both bf16; the surrogate's
# wave with half its pops on slab 0 (~24,600 pairs: the pad slab the beam
# clamps stale pops to); two f32 shapes, the second exp_block_geometry's
# default wave (512 x 8 popped slabs of 256 x 384: 384 KiB a slab); ragged
# cases (W = 5, L = 100, d = 50; W = 1, L = 12, d = 40) with ids 0 and
# Nb - 1 and repeated ids; the benchmark cell glove50.hnsw's wave (256 x 96
# slabs of 256 x 50 over 4,624: a 100-byte bf16 row, K2's masked loads).
# Every graph row's own launches are checked in phase 5b (check_launched).
K2_SHAPES = (
    (512, 96, 128, 384, 782, "bf16", 0.0),
    (256, 96, 256, 50, 4624, "bf16", 0.0),
    (256, 62, 256, 128, 3907, "bf16", 0.0),
    (512, 96, 128, 384, 782, "bf16", 0.5),
    (256, 40, 128, 384, 782, "f32", 0.0),
    (512, 8, 256, 384, 391, "f32", 0.0),
    (300, 7, 256, 128, 50, "f32", 0.3),
    (7, 5, 100, 50, 13, "bf16", 0.0),
    (7, 5, 100, 50, 13, "f32", 0.0),
    (64, 1, 12, 40, 5, "bf16", 0.0),
)
# out-of-range ids (-1 and Nb) among in-range ones, per slab dtype: (B, W, L, d, Nb)
K2_NAN_SHAPE = (200, 12, 128, 64, 9)
# (B, N, d, w, padding rows of 1e6): the JAX oracle's shape, w = 32
# (seg = 64), a ragged B, a ragged B over 3 query tiles, three tiles at
# w = 128 (seg = 16: 8 members an n-tile), and exact search's flagship padded
# to 49 tiles (the last: the throughput phase's shape)
K4_SHAPES = (
    (8, 4096, 32, 8, 0),
    (8, 4096, 32, 32, 0),
    (7, 4096, 17, 16, 0),
    (300, 8192, 96, 8, 0),
    (64, 6144, 64, 128, 0),
    (256, 100_352, 384, 8, 352),
)
# K5 (matmul_floor), (B, S, d, w, offset): the flagship (100,032 rows,
# exp_dbm_tune's padding of 100k at w = 8) and the SIFT shape (1M at w = 32:
# 1,000,192 rows) of phase 7d's two runs, a ragged B and d, every width of the
# epilogue over a ragged B (two query tiles) with S off the 128-row tile (but
# for w = 128), and the two rows of tests/test_torch_kernels.py's
# K5_EDGE_SHAPES: d % 4 != 0 at w = 32, and the payload a view `offset`
# elements into its buffer (a base 4 bytes past a 16-byte boundary); both
# take the kernel's masked loads. Phase 7d's own launches are checked there
# (check_launched)
K5_SHAPES = (
    (256, 100_032, 384, 8, 0),
    (256, 1_000_192, 128, 32, 0),
    (300, 5_000, 50, 8, 0),
    *((130, w * (3001 // w + 1), 96, w, 0) for w in (8, 16, 32, 64, 128)),
    (130, 4096, 98, 32, 0),
    (256, 4096, 384, 8, 1),
)
# PR 17's K5 (the FLOOR mode of K1 f32's kernel) at phase 7d's two shapes,
# ms on an H100 80GB HBM3 at 700 W (PERF.md, call 5 of PR 17): the time
# the redesign is set beside
K5_EARLIER_MS = {(256, 100_032, 384, 8): 0.311, (256, 1_000_192, 128, 32): 0.755}
# K6 (block_rescore), (B, n, d, w, nb, metric, rows, offset): the two
# exact cells' shapes (sift1m.exact: integer rows, l2, w 32;
# msmarco100k.exact: ip, w 8, d 384), integer rows under ip, d % 4 != 0
# (single floats), d 200 / 768 / 2048 (two and four 16-byte chunks a lane,
# one to four passes over a row), w 64 and 128 (row groups of 32) and the
# payload a view one element into its buffer (4 bytes past a 16-byte
# boundary: single floats); n is never a multiple of w but at 1M, and the
# last (ragged) block is always selected
K6_SHAPES = (
    (256, 1_000_000, 128, 32, 116, "l2", "int", 0),
    (512, 100_000, 384, 8, 36, "ip", "float", 0),
    (300, 20_001, 96, 16, 21, "ip", "int", 0),
    (37, 5_003, 50, 16, 9, "l2", "float", 0),
    (7, 2_001, 3, 8, 5, "ip", "float", 0),
    (33, 10_001, 200, 16, 20, "l2", "float", 0),
    (20, 9_001, 768, 32, 7, "ip", "float", 0),
    (9, 3_001, 2048, 8, 3, "l2", "float", 0),
    (64, 20_003, 384, 64, 12, "l2", "float", 0),
    (16, 4_099, 96, 128, 4, "ip", "int", 0),
    (40, 6_001, 128, 32, 10, "l2", "float", 1),
)
# K6 against its plain version on float rows: both are elementwise f32
# sums of <= 2048 terms taken in another order (a lane's run of its columns
# and a butterfly over the lanes, against PyTorch's reduction tree), so they
# differ by a few roundings of the largest partial sums: 1e-6 of the
# largest |score|. On integer rows every partial sum is an integer below
# 2^24, exact in any order: the two must be equal.
K6_REL_TOL = 1e-6
# the benchmark's exact cells (retrieval_bench/workloads): K6 at their
# shapes (corpus, batch, k) on the port's surrogates of their data
K6_CELLS = (
    {"cell": "sift1m.exact", "data": "sift1m_surrogate", "metric": "l2",
     "n": SIFT_ROWS, "d": 128, "batch": 256, "k": 100},
    {"cell": "msmarco100k.exact", "data": "msmarco_surrogate", "metric": "cosine",
     "n": 100_000, "d": 384, "batch": 512, "k": 20},
)
# ivf_block_rescore (IVF-Flat's stage 3 over bf16 lists), (B, S, d, w, nb,
# metric, rows, offset): sift1m.ivf_flat's shape (B 256, nb 116, w 32, d 128
# on the SIFT surrogate's 1,531,648 slots), w 16 and 8, d 64 and 32 (4 and
# 8 rows a warp load), d 50 (single loads), d 384 and 768 (two and four
# 16-byte chunks a lane past 32 chunks), w 128, integer rows under ip and
# the payload a view one element into its buffer (single loads); a tenth of
# the slots dead, a tenth of the pairs never probed, one block shared by
# every query
IVF_RESCORE_SHAPES = (
    (256, 1_531_648, 128, 32, 116, "l2", "int", 0),
    (64, 65_536, 128, 16, 60, "l2", "float", 0),
    (64, 65_536, 128, 8, 80, "ip", "int", 0),
    (33, 32_768, 64, 32, 20, "l2", "float", 0),
    (17, 16_384, 32, 16, 9, "ip", "float", 0),
    (37, 20_480, 50, 16, 9, "l2", "float", 0),
    (20, 16_384, 384, 32, 7, "ip", "float", 0),
    (9, 8_192, 768, 64, 3, "l2", "float", 0),
    (16, 8_192, 96, 128, 4, "ip", "int", 0),
    (40, 12_288, 128, 32, 10, "l2", "float", 1),
)
# sources whose kernels run on the CUDA cores by design (no HGMMA expected)
CUDA_CORE_SOURCES = ("block_rescore",)
# the per-product precision line: B x N rows of seeded normals at d = 4
# with three columns zero, so each output holds one product
PRODUCT_SHAPE = (300, 65_536)
ASSIGN_CENTROIDS = 257  # three centroid n-tiles, the last ragged
_MODE_NAME = {"f32": "dist_blockmin", "bf16": "dist_blockmin_bf16",
              "u8": "dist_blockmin_u8"}
PAIR = "dist_blockmin_pair"  # counts under its payload's mode


def _dtype_modes():
    import torch

    return {torch.float32: "f32", torch.bfloat16: "bf16", torch.uint8: "u8"}


def _k1_inputs(b, n, d, w, dead, pen_kind, seed, mode="f32"):
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    g = torch.Generator(device=DEV).manual_seed(seed)
    s = kernels.dist_blockmin_pad_rows(n, w)
    q = torch.randn((b, d), generator=g, device=DEV)
    x = torch.zeros((s, d), device=DEV)
    x[:n] = torch.randn((n, d), generator=g, device=DEV)
    if mode == "bf16":
        x = x.to(torch.bfloat16)
    elif mode == "u8":
        x = torch.randint(0, 256, (s, d), generator=g, device=DEV,
                          dtype=torch.uint8)
    xf = x.float()
    pen = (xf * xf).sum(-1) if pen_kind == "l2" else torch.zeros(s, device=DEV)
    pen[n:] = float("inf")
    if dead:
        pen[torch.rand(s, generator=g, device=DEV) < dead] = float("inf")
        pen[: 3 * w] = float("inf")  # three whole dead blocks -> +inf minima
    return q, x, pen.reshape(s // w, w).contiguous()


def _blockmin_diff(got, want):
    """(+inf positions equal, NaN in got, max abs error over finite entries,
    max |want| there)."""
    import torch

    inf_ok = torch.equal(torch.isinf(got), torch.isinf(want))
    nan = bool(torch.isnan(got).any())
    fin = ~torch.isinf(want)
    err = float((got - want)[fin].abs().max()) if fin.any() else 0.0
    scale = float(want[fin].abs().max()) if fin.any() else 0.0
    return inf_ok, nan, err, scale


def check_dist_blockmin(q, x, pen, w, where, quiet=False) -> float:
    """One dist_blockmin launch against its plain version on the same
    inputs: identical +inf positions, no NaN, max error <= 1e-5 x max|plain|.
    Emits the check (``quiet``: only a failing one) and returns the max abs
    error."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    got = kernels.dist_blockmin(q, x, pen, w=w)
    want = kernels.dist_blockmin_reference(q, x, pen, w=w)
    torch.cuda.synchronize()
    name = _MODE_NAME[_dtype_modes()[x.dtype]]
    inf_ok, nan, err, scale = _blockmin_diff(got, want)
    ok = inf_ok and not nan and err <= KERNEL_REL_TOL * scale
    if not ok or not quiet:
        emit({"phase": "kernel_check", "kernel": name, "at": where,
              "shape": [q.shape[0], x.shape[0], x.shape[1], w],
              "dead_blocks": int(torch.isinf(want[0]).sum()),
              "dead_slots": int(torch.isinf(pen).sum()),
              "max_abs_err": err, "max_abs_plain": scale,
              "tol": KERNEL_REL_TOL * scale, "inf_equal": inf_ok, "nan": nan, "ok": ok})
    if not ok:
        raise AssertionError(f"{name} {where}: err {err}, +inf equal {inf_ok}, NaN {nan}")
    return err


def check_dist_blockmin_pair(q, x, pen_a, pen_b, w, where, quiet=False) -> float:
    """One dist_blockmin_pair launch against its plain version on the same
    inputs, each output held as check_dist_blockmin holds one. Emits the
    check (``quiet``: only a failing one) and returns the max abs error."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    got = kernels.dist_blockmin_pair(q, x, pen_a, pen_b, w=w)
    want = kernels.dist_blockmin_pair_reference(q, x, pen_a, pen_b, w=w)
    torch.cuda.synchronize()
    diffs = [_blockmin_diff(g, h) for g, h in zip(got, want)]
    ok = all(i and not n and e <= KERNEL_REL_TOL * s for i, n, e, s in diffs)
    err = max(e for _, _, e, _ in diffs)
    if not ok or not quiet:
        emit({"phase": "kernel_check", "kernel": PAIR,
              "mode": _dtype_modes()[x.dtype], "at": where,
              "shape": [q.shape[0], x.shape[0], x.shape[1], w],
              "dead_blocks": [int(torch.isinf(h[0]).sum()) for h in want],
              "max_abs_err": [e for _, _, e, _ in diffs],
              "tol": [KERNEL_REL_TOL * s for _, _, _, s in diffs],
              "inf_equal": [i for i, _, _, _ in diffs], "nan": [n for _, n, _, _ in diffs],
              "ok": ok})
    if not ok:
        raise AssertionError(f"{PAIR} {where}: {diffs}")
    return err


def check_matmul_floor(q, x, w, where, quiet=False) -> float:
    """One matmul_floor launch against its plain version on the same
    inputs: the same [S/w, B] shape, no NaN, max error <= 1e-5 x max|plain|
    (3xTF32 against FP32 sums, as K1 f32); both against float64 beside it
    (reported: at d = 384 the plain version's own error is most of the
    gap). Emits the check (``quiet``: only a failing one) and returns the
    max abs error."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    got = kernels.matmul_floor(q, x, w=w)
    want = kernels.matmul_floor_reference(q, x, w)
    exact = x[::w].double() @ q.double().T
    torch.cuda.synchronize()
    nan = bool(torch.isnan(got).any())
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    ok = got.shape == want.shape and not nan and err <= KERNEL_REL_TOL * scale
    if not ok or not quiet:
        err64 = float((got.double() - exact).abs().max()) if want.numel() else 0.0
        plain64 = float((want.double() - exact).abs().max()) if want.numel() else 0.0
        emit({"phase": "kernel_check", "kernel": "matmul_floor", "at": where,
              "shape": [q.shape[0], x.shape[0], x.shape[1], w],
              "payload_aligned": x.data_ptr() % 16 == 0, "max_abs_err": err,
              "max_abs_plain": scale, "rel_err": err / scale if scale else 0.0,
              "max_abs_err_f64": err64, "plain_max_abs_err_f64": plain64,
              "tol": KERNEL_REL_TOL * scale, "nan": nan, "ok": ok})
    if not ok:
        raise AssertionError(f"matmul_floor {where}: err {err}, NaN {nan}")
    return err


def check_matmul_floor_shape(b, s, d, w, offset, seed) -> float:
    """K5 on seeded normals, the payload a view ``offset`` elements into
    its buffer."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((b, d), generator=g, device=DEV)
    x = torch.randn((s * d + offset,), generator=g, device=DEV)[offset:].view(s, d)
    err = check_matmul_floor(q, x, w, "synthetic" if offset == 0 else f"view+{offset}")
    del q, x
    torch.cuda.empty_cache()
    return err


def check_block_rescore(q, x, blk, n, w, metric, where, exact=False, quiet=False) -> float:
    """One block_rescore launch against its plain version on the same
    inputs: the row ids equal, identical +inf positions, no NaN, the scores
    equal where the rows are integers (``exact``) and within K6_REL_TOL x
    max|plain| otherwise. Emits the check (``quiet``: only a failing one)
    and returns the max abs error."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    cd, cand = kernels.block_rescore(q, x, blk, n, w, metric)
    b, nb = blk.shape
    # the plain version gathers a [rows, nb, w, d] copy: at most 256 MB of
    # it at a time (the probes' children share the card)
    step = max(1, (1 << 26) // (nb * w * x.shape[1]))
    want = [kernels.block_rescore_reference(q[i:i + step], x, blk[i:i + step], n, w, metric)
            for i in range(0, b, step)]
    want_cd, want_cand = torch.cat([c for c, _ in want]), torch.cat([c for _, c in want])
    torch.cuda.synchronize()
    ids_ok = bool(torch.equal(cand, want_cand))
    inf_ok, nan, err, scale = _blockmin_diff(cd, want_cd)
    tol = 0.0 if exact else K6_REL_TOL * scale
    ok = ids_ok and inf_ok and not nan and err <= tol
    if not ok or not quiet:
        emit({"phase": "kernel_check", "kernel": "block_rescore", "at": where,
              "shape": [b, x.shape[0], x.shape[1], w, nb], "metric": metric,
              "n": n, "payload_aligned": x.data_ptr() % 16 == 0,
              "padding_rows": int((want_cand < 0).sum()),
              "max_abs_err": err, "max_abs_plain": scale,
              "rel_err": err / scale if scale else 0.0, "tol": tol,
              "ids_equal": ids_ok, "inf_equal": inf_ok, "nan": nan, "ok": ok})
    if not ok:
        raise AssertionError(f"block_rescore {where}: err {err}, ids equal {ids_ok}, "
                             f"+inf equal {inf_ok}, NaN {nan}")
    return err


def check_block_rescore_shape(b, n, d, w, nb, metric, rows, offset, seed) -> float:
    """K6 on seeded rows (``rows`` "int": integers 0-255, else normals),
    zero padding rows up to whole blocks, the payload a view ``offset``
    elements into its buffer, random block ids (the last block always
    among them)."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    gen = torch.Generator(device=DEV).manual_seed(seed)
    s = kernels.dist_blockmin_pad_rows(n, w)

    def draw(*shape):
        if rows == "int":
            return torch.randint(0, 256, shape, generator=gen, device=DEV).float()
        return torch.randn(shape, generator=gen, device=DEV)

    q = draw(b, d)
    x = torch.zeros((s * d + offset,), device=DEV)[offset:].view(s, d)
    x[:n] = draw(n, d)
    blk = torch.randint(0, s // w, (b, nb), generator=gen, device=DEV)
    blk[0, 0] = s // w - 1
    where = "synthetic" if offset == 0 else f"view+{offset}"
    err = check_block_rescore(q, x, blk, n, w, metric, where, exact=rows == "int")
    del q, x, blk
    torch.cuda.empty_cache()
    return err


def check_ivf_block_rescore(q, x, slots, blk, vals, w, metric, where, exact=False,
                            quiet=False) -> float:
    """One ivf_block_rescore launch against its plain version on the same
    inputs: the row ids equal, identical +inf positions, no NaN, the scores
    equal where the rows are integers (``exact``) and within K6_REL_TOL x
    max|plain| otherwise. Emits the check (``quiet``: only a failing one)
    and returns the max abs error."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    cd, cand = kernels.ivf_block_rescore(q, x, slots, blk, vals, w, metric)
    b, nb = blk.shape
    # the plain version gathers [rows, nb, w, d] bf16 and f32 copies: at most
    # 256 MB of the f32 one at a time
    step = max(1, (1 << 26) // (nb * w * x.shape[1]))
    want = [kernels.ivf_block_rescore_reference(q[i:i + step], x, slots, blk[i:i + step],
                                                vals[i:i + step], w, metric)
            for i in range(0, b, step)]
    want_cd, want_cand = torch.cat([c for c, _ in want]), torch.cat([c for _, c in want])
    torch.cuda.synchronize()
    ids_ok = bool(torch.equal(cand, want_cand))
    inf_ok, nan, err, scale = _blockmin_diff(cd, want_cd)
    tol = 0.0 if exact else K6_REL_TOL * scale
    ok = ids_ok and inf_ok and not nan and err <= tol
    if not ok or not quiet:
        emit({"phase": "kernel_check", "kernel": "ivf_block_rescore", "at": where,
              "shape": [b, x.shape[0], x.shape[1], w, nb], "metric": metric,
              "payload_aligned": x.data_ptr() % 16 == 0,
              "unprobed_pairs": int((~torch.isfinite(vals)).sum()),
              "dead_rows": int((want_cand < 0).sum()),
              "max_abs_err": err, "max_abs_plain": scale,
              "rel_err": err / scale if scale else 0.0, "tol": tol,
              "ids_equal": ids_ok, "inf_equal": inf_ok, "nan": nan, "ok": ok})
    if not ok:
        raise AssertionError(f"ivf_block_rescore {where}: err {err}, ids equal {ids_ok}, "
                             f"+inf equal {inf_ok}, NaN {nan}")
    return err


def check_ivf_block_rescore_shape(b, s, d, w, nb, metric, rows, offset, seed) -> float:
    """The IVF bf16 rescore on seeded bf16 lists (``rows`` "int": integers
    0-255, exact in bf16; else normals), the payload a view ``offset``
    elements into its buffer, a tenth of the slots dead, random block ids
    with one block in every query's selection, a tenth of the pairs never
    probed."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    gen = torch.Generator(device=DEV).manual_seed(seed)

    def draw(*shape):
        if rows == "int":
            return torch.randint(0, 256, shape, generator=gen, device=DEV).float()
        return torch.randn(shape, generator=gen, device=DEV)

    q = draw(b, d)
    x = torch.zeros((s * d + offset,), dtype=torch.bfloat16, device=DEV)[offset:].view(s, d)
    x.copy_(draw(s, d))
    slots = torch.randperm(s, generator=gen, device=DEV).to(torch.int32)
    slots[torch.rand(s, generator=gen, device=DEV) < 0.1] = -1
    blk = torch.randint(0, s // w, (b, nb), generator=gen, device=DEV)
    blk[1:, 0] = blk[0, 0]
    vals = torch.rand((b, nb), generator=gen, device=DEV)
    vals[torch.rand((b, nb), generator=gen, device=DEV) < 0.1] = float("inf")
    where = "synthetic" if offset == 0 else f"view+{offset}"
    err = check_ivf_block_rescore(q, x, slots, blk, vals, w, metric, where, exact=rows == "int")
    del q, x, slots, blk, vals
    torch.cuda.empty_cache()
    return err


def check_assign(n, k, d, dup, seed) -> float:
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    p = torch.randn((n, d), generator=g, device=DEV)
    c = torch.randn((k, d), generator=g, device=DEV)
    if dup:  # exact duplicates: the lower id must win every tie
        c[7] = c[2]
        c[k - 1] = c[0]
    err = check_assign_on(p, c, "synthetic", dup)
    del p
    torch.cuda.empty_cache()
    return err


def check_assign_on(p, c, where, dup=False) -> float:
    """One assign launch against its plain version on the same inputs: ids
    agree on >= 99.9 %, in range, min distances within 1e-5 x max|plain|;
    with ``dup`` (centroid 7 = 2, K-1 = 0) no point takes a higher
    duplicate's id. Emits the check and returns the max abs error."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    n, d = p.shape
    k = c.shape[0]
    ids, mins = kernels.assign(p, c)
    want_ids, want_mins = kernels.assign_reference(p, c)
    torch.cuda.synchronize()
    agree = float((ids == want_ids).float().mean())
    err = float((mins - want_mins).abs().max())
    scale = float(want_mins.abs().max())
    ok = agree >= ASSIGN_MIN_AGREE and err <= KERNEL_REL_TOL * scale
    ok = ok and int(ids.min()) >= 0 and int(ids.max()) < k
    if dup:
        ok = ok and not bool(((ids == 7) | (ids == k - 1)).any())
    emit({"phase": "kernel_check", "kernel": "assign", "at": where,
          "shape": [n, k, d], "duplicated_centroids": dup, "agreement": agree,
          "min_agreement": ASSIGN_MIN_AGREE, "max_abs_err": err,
          "tol": KERNEL_REL_TOL * scale, "ok": ok})
    if not ok:
        raise AssertionError(f"assign {where} {(n, k, d)}: agreement {agree}, err {err}")
    return err


def slab_groups(sel, nb) -> dict:
    """How K2's grouping spreads one launch's pairs: the distinct blocks,
    the largest bucket (the pad slab on the main path) and the work items
    (kernels.slab_work_items, the grouping's plain version) beside their
    static bound."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    flat = sel.reshape(-1).long()
    counts = torch.bincount(torch.where((flat >= 0) & (flat < nb), flat, nb), minlength=nb + 1)
    _, _, n_items = kernels.slab_work_items(sel, nb)
    return {"pairs": flat.numel(), "distinct_blocks": int((counts[:nb] > 0).sum()),
            "largest_group": int(counts.max()), "items": int(n_items),
            "max_items": kernels.slab_max_items(flat.numel(), nb)}


def check_slab_dots(q, lv, sel, where) -> float:
    """One slab_dots launch against its plain version on the same inputs:
    NaN exactly on the rows of ids outside [0, Nb) (none on the main path),
    elsewhere max error <= 1e-5 x max|plain| (both sum f32-class products of
    the f32 query with the stored values, in another order). Emits the
    check with the grouping's spread and returns the max abs error."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    nb = lv.shape[0]
    bad = (sel < 0) | (sel >= nb)
    got = kernels.slab_dots(q, lv, sel)
    want = kernels.slab_dots_reference(q, lv, sel.clamp(0, nb - 1))
    torch.cuda.synchronize()
    nan_rows = torch.isnan(got).any(-1)
    nan_ok = torch.equal(nan_rows, bad) and bool(torch.isnan(got[bad]).all())
    good = ~bad
    err = float((got[good] - want[good]).abs().max()) if good.any() else 0.0
    scale = float(want[good].abs().max()) if good.any() else 0.0
    ok = nan_ok and err <= KERNEL_REL_TOL * scale
    b, w = sel.shape
    emit({"phase": "kernel_check", "kernel": "slab_dots", "at": where,
          "shape": [b, w, lv.shape[1], lv.shape[2]], "n_blocks": nb,
          "slab_dtype": str(lv.dtype).split(".")[-1], **slab_groups(sel, nb),
          "out_of_range_pairs": int(bad.sum()), "nan_rows_ok": nan_ok,
          "max_abs_err": err, "max_abs_plain": scale,
          "tol": KERNEL_REL_TOL * scale, "ok": ok})
    if not ok:
        raise AssertionError(f"slab_dots {where}: err {err}, NaN rows as expected {nan_ok}")
    return err


def check_slab_dots_shape(b, w, length, d, nb, dtype, pad, seed, out_of_range=False) -> float:
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((b, d), generator=g, device=DEV)
    lv = torch.randn((nb, length, d), generator=g, device=DEV)
    if dtype == "bf16":
        lv = lv.to(torch.bfloat16)
    sel = torch.randint(0, nb, (b, w), generator=g, device=DEV, dtype=torch.int32)
    sel[torch.rand((b, w), generator=g, device=DEV) < pad] = 0  # the pad slab
    sel[0, 0], sel[-1, -1] = 0, nb - 1  # both ends of the id range
    if w > 1:
        sel[:, 1] = sel[:, 0]  # a block popped twice in a row
    sel[1] = sel[0]  # two queries popping the same blocks
    where = f"synthetic/{dtype}"
    if out_of_range:  # not clamped: NaN rows
        sel[3, 2], sel[7, w - 1], sel[-1, 0] = -1, nb, nb + 5
        where += "/out_of_range"
    err = check_slab_dots(q, lv, sel, where)
    del lv
    torch.cuda.empty_cache()
    return err


@contextlib.contextmanager
def capture_launch_inputs(store: dict, stage: list, pairs: list = None,
                          counts: dict = None):
    """While active, keep in ``store`` the inputs of the last launch of
    each kernel mode at each shape in each stage (``stage[0]``, set by the
    caller), so that ``check_launched`` can hold every kernel against its
    plain version on the main path's own inputs (a launch on the same
    inputs gives the same output: K2's grouping orders the pairs of a slab
    by atomics, but no output depends on that order). A PQ training's
    subspaces share one shape, so one check covers each subspace width.
    ``pairs[0]``, where given, counts the dist_blockmin_pair calls, and
    ``counts``, where given, the calls under each key. The launches
    themselves and their counts are the wrappers' own."""
    from vectordb_retrieval_tpu_torch.ops import kernels

    orig_dbm, orig_assign = kernels.dist_blockmin, kernels.assign
    orig_slab, orig_pair = kernels.slab_dots, kernels.dist_blockmin_pair
    orig_floor, orig_rescore = kernels.matmul_floor, kernels.block_rescore
    orig_ivf_rescore = kernels.ivf_block_rescore
    modes = _dtype_modes()

    def keep(key, args):
        store[key] = args
        if counts is not None:
            counts[key] = counts.get(key, 0) + 1

    def dist_blockmin(queries, payload, pen, w=8, chunk_rows=None):
        out = orig_dbm(queries, payload, pen, w=w, chunk_rows=chunk_rows)
        name = _MODE_NAME[modes[payload.dtype]]
        keep((stage[0], name, tuple(queries.shape), tuple(payload.shape), w),
             (queries, payload, pen, w))
        return out

    def dist_blockmin_pair(queries, payload, pen_a, pen_b, w=8, chunk_rows=None):
        out = orig_pair(queries, payload, pen_a, pen_b, w=w, chunk_rows=chunk_rows)
        keep((stage[0], PAIR, tuple(queries.shape), tuple(payload.shape), w),
             (queries, payload, pen_a, pen_b, w))
        if pairs is not None:
            pairs[0] += 1
        return out

    def assign(points, centroids, chunk_rows=None):
        out = orig_assign(points, centroids, chunk_rows=chunk_rows)
        keep((stage[0], "assign", tuple(points.shape), tuple(centroids.shape)),
             (points, centroids))
        return out

    def slab_dots(queries, list_vecs, sel):
        out = orig_slab(queries, list_vecs, sel)
        keep((stage[0], "slab_dots", tuple(queries.shape), tuple(list_vecs.shape),
              tuple(sel.shape)), (queries, list_vecs, sel))
        return out

    def matmul_floor(queries, payload, w=8):
        out = orig_floor(queries, payload, w=w)
        keep((stage[0], "matmul_floor", tuple(queries.shape), tuple(payload.shape), w),
             (queries, payload, w))
        return out

    def block_rescore(queries, payload, blk, n, w, metric):
        out = orig_rescore(queries, payload, blk, n, w, metric)
        keep((stage[0], "block_rescore", tuple(queries.shape), tuple(payload.shape),
              tuple(blk.shape), w, metric), (queries, payload, blk, n, w, metric))
        return out

    def ivf_block_rescore(queries, payload, slot_ids, blk, blk_vals, w, metric):
        out = orig_ivf_rescore(queries, payload, slot_ids, blk, blk_vals, w, metric)
        keep((stage[0], "ivf_block_rescore", tuple(queries.shape), tuple(payload.shape),
              tuple(blk.shape), w, metric),
             (queries, payload, slot_ids, blk, blk_vals, w, metric))
        return out

    kernels.dist_blockmin, kernels.assign = dist_blockmin, assign
    kernels.slab_dots, kernels.dist_blockmin_pair = slab_dots, dist_blockmin_pair
    kernels.matmul_floor, kernels.block_rescore = matmul_floor, block_rescore
    kernels.ivf_block_rescore = ivf_block_rescore
    try:
        yield store
    finally:
        kernels.dist_blockmin, kernels.assign = orig_dbm, orig_assign
        kernels.slab_dots, kernels.dist_blockmin_pair = orig_slab, orig_pair
        kernels.matmul_floor, kernels.block_rescore = orig_floor, orig_rescore
        kernels.ivf_block_rescore = orig_ivf_rescore


def check_launched(store: dict, prefix: str, worst: dict) -> None:
    """Every captured launch input against the kernel's plain version (the
    checks' own launches come after the main path's counts are read)."""
    import torch

    for key, args in store.items():
        where = f"{prefix}/{key[0]}"
        if key[1] == "assign":
            err = check_assign_on(*args, where)
        elif key[1] == "slab_dots":
            err = check_slab_dots(*args, where)
        elif key[1] == PAIR:
            err = check_dist_blockmin_pair(*args, where)
        elif key[1] == "matmul_floor":
            err = check_matmul_floor(*args, where)
        elif key[1] == "block_rescore":
            err = check_block_rescore(*args, where)
        elif key[1] == "ivf_block_rescore":
            err = check_ivf_block_rescore(*args, where)
        else:
            q, x, pen, w = args
            err = check_dist_blockmin(q, x, pen, w, where)
        worst[key[1]] = max(worst[key[1]], err)
    store.clear()
    torch.cuda.empty_cache()


def _k4_inputs(b, n, d, pad, seed):
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((b, d), generator=g, device=DEV)
    x = torch.randn((n, d), generator=g, device=DEV)
    if pad:
        x[n - pad:] = 1e6
    return q, x


def check_blockmin(q, x, w, n_real, where) -> float:
    """One blockmin launch against its plain version on the same inputs: no
    NaN, max error <= 1e-5 x the largest ||q||^2 + ||x||^2 over real rows.
    Emits the check and returns the max abs error."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    got = kernels.blockmin(q, x, w=w)
    want = kernels.blockmin_reference(q, x, w=w)
    torch.cuda.synchronize()
    scale = float((q * q).sum(1).max() + (x[:n_real] * x[:n_real]).sum(1).max())
    nan = bool(torch.isnan(got).any())
    err = float((got - want).abs().max())
    ok = not nan and err <= KERNEL_REL_TOL * scale
    emit({"phase": "kernel_check", "kernel": "blockmin", "at": where,
          "shape": [q.shape[0], x.shape[0], x.shape[1], w],
          "padding_rows": x.shape[0] - n_real, "max_abs_err": err,
          "max_norm_sum": scale, "tol": KERNEL_REL_TOL * scale, "nan": nan, "ok": ok})
    if not ok:
        raise AssertionError(f"blockmin {where}: err {err}, nan {nan}")
    return err


def _k1_tc_sweep(worst: dict) -> None:
    """K1's modes over every combination of K1_TC_B, K1_TC_D and K1_TC_W:
    one pen (l2 and zero) and, for bf16 and u8, the pair (the l2 pen beside
    the zero pen with slot 0 of every block dead too). One line per mode."""
    import torch

    for mode in ("f32", "bf16", "u8"):
        name = _MODE_NAME[mode]
        worst_one = worst_pair = 0.0
        n = 0
        for b in K1_TC_B:
            for d in K1_TC_D:
                for w in K1_TC_W:
                    seed = SEED + b + d + w
                    args = (b, 1000 + 37 * w, d, w, 0.1)
                    q, x, pen_l2 = _k1_inputs(*args, "l2", seed, mode)
                    _, _, pen_zero = _k1_inputs(*args, "zero", seed, mode)
                    pen_zero[:: 2 if w == 1 else 1, 0] = float("inf")  # more dead slots
                    where = f"sweep/B={b}/d={d}/w={w}"
                    for pen in (pen_l2, pen_zero):
                        err = check_dist_blockmin(q, x, pen, w, where, quiet=True)
                        worst_one = max(worst_one, err)
                    if mode != "f32":
                        err = check_dist_blockmin_pair(q, x, pen_l2, pen_zero, w, where,
                                                       quiet=True)
                        worst_pair = max(worst_pair, err)
                    n += 1
        torch.cuda.empty_cache()
        worst[name] = max(worst[name], worst_one)
        worst[PAIR] = max(worst[PAIR], worst_pair)
        emit({"phase": "kernel_check_sweep", "kernel": name, "shapes": n,
              "launches_checked": (2 if mode == "f32" else 3) * n,
              "B": list(K1_TC_B), "d": list(K1_TC_D),
              "w": list(K1_TC_W), "rows": "1000 + 37 w, padded to S % w == 0",
              "dead": "10 % of slots and 3 whole blocks", "max_abs_err": worst_one,
              "pair_max_abs_err": worst_pair if mode != "f32" else None,
              "tol": f"{KERNEL_REL_TOL} x max|plain|", "ok": True})


def phase_product_precision(card: str) -> None:
    """K1 f32 (w = 1, zero pen), blockmin (w = 1) and assign where each
    output holds one product: q and x at d = 4 with columns 1-3 zero, so the
    sums add exact zeros and only the route's own product error shows. Each
    entry against float64 of the same f32 inputs, within PRODUCT_REL_TOL of
    |2 q0 x0| (K1) or of qn + xn (blockmin; assign: pn + cn of the centroid
    it chose, the first ASSIGN_CENTROIDS rows of x as centroids); the plain
    version's error (FP32, TF32 off) beside it."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    b, n = PRODUCT_SHAPE
    g = torch.Generator(device=DEV).manual_seed(SEED)
    q = torch.zeros((b, 4), device=DEV)
    x = torch.zeros((n, 4), device=DEV)
    q[:, 0] = torch.randn(b, generator=g, device=DEV)
    x[:, 0] = torch.randn(n, generator=g, device=DEV)
    q64, x64 = q[:, 0].double(), x[:, 0].double()
    prod = q64[:, None] * x64[None, :]
    zero = torch.zeros((n, 1), device=DEV)
    want = -2.0 * prod
    scale = want.abs()
    k1 = kernels.dist_blockmin(q, x, zero, w=1).double()
    k1_plain = kernels.dist_blockmin_reference(q, x, zero, w=1).double()
    want4 = (q64[:, None] - x64[None, :]) ** 2
    scale4 = (q64 * q64)[:, None] + (x64 * x64)[None, :]
    k4 = kernels.blockmin(q, x, w=1).double()
    k4_plain = kernels.blockmin_reference(q, x, w=1).double()
    # assign: the points x against centroids q[:ASSIGN_CENTROIDS]
    c64 = q64[:ASSIGN_CENTROIDS]
    k3, k3_plain = (fn(x, q[:ASSIGN_CENTROIDS].contiguous())
                    for fn in (kernels.assign, kernels.assign_reference))
    torch.cuda.synchronize()

    def k3_rel(out):
        ids, mins = out
        ref = (x64 - c64[ids]) ** 2
        return float(((mins.double() - ref).abs() / (x64 * x64 + c64[ids] ** 2)).max())

    rel = {name: float(((got - ref).abs() / s).max())
           for name, got, ref, s in (("dist_blockmin", k1, want, scale),
                                     ("dist_blockmin_plain", k1_plain, want, scale),
                                     ("blockmin", k4, want4, scale4),
                                     ("blockmin_plain", k4_plain, want4, scale4))}
    rel["assign"], rel["assign_plain"] = k3_rel(k3), k3_rel(k3_plain)
    ok = all(rel[name] <= PRODUCT_REL_TOL for name in ("dist_blockmin", "blockmin", "assign"))
    emit({"phase": "product_precision", "card": card, "shape": [b, n, 4],
          "assign_shape": [n, ASSIGN_CENTROIDS, 4],
          "nonzero_columns": 1, "max_rel_err": rel, "tol": PRODUCT_REL_TOL,
          "relative_to": {"dist_blockmin": "|2 q0 x0|", "blockmin": "qn + xn",
                          "assign": "pn + cn of the chosen centroid"}, "ok": ok})
    del prod, want, scale, k1, k1_plain, want4, scale4, k4, k4_plain, k3, k3_plain
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"per-product precision: {rel}")
    phase_depth_precision(card)


# the accumulation line: B unit-vector queries against N unit vectors at
# each d (the first 64 rows copies of queries: the largest scores)
DEPTH_SHAPE = (512, 100_352)
DEPTH_D = (128, 384)


def phase_depth_precision(card: str) -> None:
    """K1 f32 (w = 1, zero pen) and blockmin (w = 1) at full depth on unit
    vectors against float64, as the max error over the max |float64|, the
    plain version's (FP32, TF32 off) beside it. Reported, not gated: here
    the f32 accumulation (the tensor cores' adds, cuBLAS's) sets the error,
    not the products."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    b, n = DEPTH_SHAPE
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    out = {}
    for d in DEPTH_D:
        q = torch.randn((b, d), generator=g, device=DEV)
        x = torch.randn((n, d), generator=g, device=DEV)
        q = q / q.norm(dim=1, keepdim=True)
        x = x / x.norm(dim=1, keepdim=True)
        x[:64] = q[:64]
        dots = q.double() @ x.double().T
        zero = torch.zeros((n, 1), device=DEV)
        want = -2.0 * dots
        qn, xn = (q.double() ** 2).sum(1), (x.double() ** 2).sum(1)
        want4 = qn[:, None] + xn[None, :] - 2.0 * dots
        for name, got, ref in (
                ("dist_blockmin", kernels.dist_blockmin(q, x, zero, w=1), want),
                ("dist_blockmin_plain", kernels.dist_blockmin_reference(q, x, zero, w=1), want),
                ("blockmin", kernels.blockmin(q, x, w=1), want4),
                ("blockmin_plain", kernels.blockmin_reference(q, x, w=1), want4)):
            out.setdefault(name, {})[d] = float((got.double() - ref).abs().max()
                                                / ref.abs().max())
            del got
        del dots, want, want4, x
        torch.cuda.empty_cache()
    emit({"phase": "depth_precision", "card": card, "shape": [b, n], "d": list(DEPTH_D),
          "data": "unit vectors", "max_err_over_max_abs": out, "gated": False})


def phase_kernels() -> dict:
    """Worst max abs error per kernel name."""
    worst = {name: 0.0 for name in (*_MODE_NAME.values(), PAIR, "assign", "slab_dots",
                                    "blockmin", "matmul_floor", "block_rescore",
                                    "ivf_block_rescore")}
    for i, (b, n, d, w, dead) in enumerate(K1_SHAPES):
        for pen_kind in ("l2", "zero"):
            q, x, pen = _k1_inputs(b, n, d, w, dead, pen_kind, SEED + i)
            err = check_dist_blockmin(q, x, pen, w, f"synthetic/{pen_kind}/dead={dead}")
            worst["dist_blockmin"] = max(worst["dist_blockmin"], err)
    for mode in ("bf16", "u8"):
        for i, (b, n, d, w, dead) in enumerate(K1_MODE_SHAPES):
            for pen_kind in ("l2", "zero"):
                q, x, pen = _k1_inputs(b, n, d, w, dead, pen_kind, SEED + i, mode)
                err = check_dist_blockmin(q, x, pen, w, f"synthetic/{pen_kind}/dead={dead}")
                worst[_MODE_NAME[mode]] = max(worst[_MODE_NAME[mode]], err)
    _k1_tc_sweep(worst)
    for i, (n, k, d, dup) in enumerate(K3_SHAPES):
        worst["assign"] = max(worst["assign"], check_assign(n, k, d, dup, SEED + i))
    for i, shape in enumerate(K2_SHAPES):
        worst["slab_dots"] = max(worst["slab_dots"], check_slab_dots_shape(*shape, SEED + i))
    for dtype in ("bf16", "f32"):
        err = check_slab_dots_shape(*K2_NAN_SHAPE, dtype, 0.5, SEED, out_of_range=True)
        worst["slab_dots"] = max(worst["slab_dots"], err)
    for i, (b, n, d, w, pad) in enumerate(K4_SHAPES):
        q, x = _k4_inputs(b, n, d, pad, SEED + i)
        err = check_blockmin(q, x, w, n - pad, "synthetic")
        worst["blockmin"] = max(worst["blockmin"], err)
    for i, shape in enumerate(K5_SHAPES):
        err = check_matmul_floor_shape(*shape, SEED + i)
        worst["matmul_floor"] = max(worst["matmul_floor"], err)
    for i, shape in enumerate(K6_SHAPES):
        err = check_block_rescore_shape(*shape, SEED + i)
        worst["block_rescore"] = max(worst["block_rescore"], err)
    for i, shape in enumerate(IVF_RESCORE_SHAPES):
        err = check_ivf_block_rescore_shape(*shape, SEED + i)
        worst["ivf_block_rescore"] = max(worst["ivf_block_rescore"], err)
    return worst


# ---- 4. exact path -----------------------------------------------------


def _runner_config(metric: str) -> dict:
    return {
        "indexers": {"brute_force": {"type": "BruteForceIndexer"}},
        "searchers": {"linear": {"type": "LinearSearcher"}},
        "algorithms": {
            "exact": {"indexer_ref": "brute_force", "searcher_ref": "linear"}
        },
        "datasets": [{
            "name": "random",
            "metric": metric,
            "dataset_options": {
                "dimensions": 384, "train_size": 100_000, "test_size": 2048,
                "ground_truth_k": 100, "seed": SEED, "use_cache": False,
            },
        }],
        "topk": TOPK,
        "n_queries": 2048,
        "query_batch_size": BATCH,
        "output_dir": os.path.join(OUT_DIR, "runs"),
        "data_dir": os.path.join(OUT_DIR, "data"),
        "output_prefix": f"exact_{metric}",
        "seed": 42,
    }


def _check_gt_float64(train, queries, gt_ids, metric, n_check=64, k=TOPK):
    """The ground truth's top-k distances against float64 difference-form
    distance rows on the card, compared as sorted values (tie-aware)."""
    import torch

    x = torch.as_tensor(train, device=DEV, dtype=torch.float64)
    q = torch.as_tensor(queries[:n_check], device=DEV, dtype=torch.float64)
    if metric == "cosine":
        x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
        q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    ids = torch.as_tensor(gt_ids[:n_check, :k], device=DEV)
    worst = 0.0
    for s in range(0, n_check, 8):
        rows = ((x[None, :, :] - q[s : s + 8, None, :]) ** 2).sum(-1)  # [8, N]
        true = rows.topk(k, dim=1, largest=False).values
        got = torch.gather(rows, 1, ids[s : s + 8]).sort(dim=1).values
        rel = float(((got - true).abs() / true.abs().amax(1, keepdim=True)).max())
        worst = max(worst, rel)
    del x
    torch.cuda.empty_cache()
    return worst


def phase_main_path(card: str, worst: dict) -> tuple:
    import torch
    import yaml

    from vectordb_retrieval_tpu_torch.bench import experiment
    from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner
    from vectordb_retrieval_tpu_torch.data import datasets
    from vectordb_retrieval_tpu_torch.ops import kernels

    gt_calls, search_calls = [], []
    launched, stage = {}, ["runner"]
    orig_gt = datasets.compute_ground_truth
    orig_search = experiment.ExperimentRunner._timed_search

    def counted_gt(train, queries, k, metric="l2", *args, **kwargs):
        before = kernels.LAUNCHES["dist_blockmin"]
        stage[0] = "ground_truth"
        ids = orig_gt(train, queries, k, metric, *args, **kwargs)
        stage[0] = "runner"
        gt_calls.append({
            "launches": kernels.LAUNCHES["dist_blockmin"] - before,
            "train": train, "queries": queries, "ids": ids, "metric": metric,
        })
        return ids

    def counted_search(self, *args, **kwargs):
        before = kernels.LAUNCHES["dist_blockmin"]
        stage[0] = "search"
        out = orig_search(self, *args, **kwargs)
        stage[0] = "runner"
        search_calls.append(kernels.LAUNCHES["dist_blockmin"] - before)
        return out

    total, exact_rows = {"dist_blockmin": 0, "block_rescore": 0}, {}
    os.makedirs(OUT_DIR, exist_ok=True)
    datasets.compute_ground_truth = counted_gt
    experiment.ExperimentRunner._timed_search = counted_search
    try:
        for metric in ("l2", "cosine"):
            gt_calls.clear()
            search_calls.clear()
            path = os.path.join(OUT_DIR, f"exact_{metric}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(_runner_config(metric), f)
            with capture_launch_inputs(launched, stage):
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                results = BenchmarkRunner(path).run()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = {name: kernels.LAUNCHES[name]
                            for name in ("dist_blockmin", "block_rescore")}
            check_launched(launched, f"exact_{metric}", worst)

            ds = results["random"]
            if "error" in ds:
                raise AssertionError(f"{metric}: dataset error {ds['error']}")
            for name, row in ds.items():
                if isinstance(row, dict) and "error" in row:
                    raise AssertionError(f"{metric}: row {name} error {row['error']}")
            row = ds["exact"]
            if row.get(f"recall@{TOPK}") != 1.0:
                raise AssertionError(f"{metric}: recall@{TOPK} = {row.get(f'recall@{TOPK}')}")
            if len(gt_calls) != 1 or gt_calls[0]["launches"] < 1:
                raise AssertionError(f"{metric}: ground truth did not launch dist_blockmin")
            if len(search_calls) != 1 or search_calls[0] < 1:
                raise AssertionError(f"{metric}: timed search did not launch dist_blockmin")
            # 100k rows lie above the dense cut: exact search's stage 3 is K6
            if launches["block_rescore"] < 1:
                raise AssertionError(f"{metric}: the exact path did not launch block_rescore")
            gt = gt_calls[0]
            ids = gt["ids"]
            n_train = gt["train"].shape[0]
            if ids.shape != (2048, 100) or ids.min() < 0 or ids.max() >= n_train:
                raise AssertionError(f"{metric}: ground truth ids malformed {ids.shape}")
            rel = _check_gt_float64(gt["train"], gt["queries"], ids, gt["metric"])
            if rel > GT_REL_TOL:
                raise AssertionError(f"{metric}: ground truth vs float64 rel err {rel}")
            emit({
                "phase": "main_path", "metric": metric, "card": card,
                "recall@20": row[f"recall@{TOPK}"], "qps": row["qps"],
                "build_time_s": row["build_time_s"],
                "index_memory_mb": row["index_memory_mb"],
                "warmup_time_s": row["warmup_time_s"],
                "runner_seconds": seconds,
                "launches": launches,
                "launches_ground_truth": gt["launches"],
                "launches_timed_search": search_calls[0],
                "gt_float64_max_rel_err": rel, "gt_float64_tol": GT_REL_TOL,
            })
            for name, count in launches.items():
                total[name] += count
            exact_rows[metric] = row
    finally:
        datasets.compute_ground_truth = orig_gt
        experiment.ExperimentRunner._timed_search = orig_search
    return total, exact_rows


# ---- 5. IVF path and 5b. graph path ----------------------------------------

# Configurations of the repo's own configs. The first is configs/sift1m.yaml
# on the SIFT1M surrogate; the second random data at the MS MARCO shape; the
# third configs/msmarco_surrogate.yaml's hnsw and PQ rows on the
# msmarco_surrogate corpus; the fourth the JAX package's per-list rotations
# A/B on the manifold corpus. Rows: (indexer, searcher), the searcher an
# ANNSearcher's nprobe or a searcher's config.
IVF_CONFIGS = (
    {
        "name": "sift1m_surrogate",
        "source": ("configs/sift1m.yaml ivf_flat, ivf_sq8, hnsw (graph_l2, mode block), "
                   "ivf_pq (ivf_pq_l2), exact, lsh on data/sift1m_synth"),
        "dataset": "sift1m", "metric": "l2", "n": SIFT_ROWS, "d": 128, "topk": 100,
        "queries": 256, "batch": 256, "gt_k": 100,
        "rows": {
            "ivf_flat": ({"type": "FactoryIndexer", "index_key": "IVF1024,Flat",
                          "nprobe": 32}, 32),
            "ivf_sq8": ({"type": "FactoryIndexer", "index_key": "IVF1024,SQ8",
                         "nprobe": 64}, 64),
            "hnsw": ({"type": "GraphIndexer", "M": 16, "efConstruction": 200,
                      "efSearch": 64, "mode": "block"}, 32),
            "ivf_pq": ({"type": "FactoryIndexer", "index_key": "IVF1024,PQ32",
                        "nprobe": 64}, 64),
            "exact": ({"type": "BruteForceIndexer"}, {"type": "LinearSearcher"}),
            "lsh": ({"type": "LSHIndexer", "num_tables": 12, "hash_size": 18,
                     "bucket_width": 256.0, "seed": 42},
                    {"type": "LSHSearcher", "candidate_multiplier": 8.0,
                     "fallback_to_bruteforce": True}),
        },
    },
    {
        "name": "msmarco_shape",
        "source": ("configs/benchmark_config.yaml msmarco ivf_flat, ivf_sq8; "
                   "hnsw_node: GraphIndexer M 16 efSearch 100 in node mode"),
        "metric": "cosine", "n": 100_000, "d": 384, "topk": 20,
        "rows": {
            "ivf_flat": ({"type": "IVFIndexer", "index_type": "IVF100,Flat",
                          "nprobe": 10}, 32),
            "ivf_sq8": ({"type": "FactoryIndexer", "index_key": "IVF256,SQ8",
                         "nprobe": 48}, 48),
            "hnsw_node": ({"type": "GraphIndexer", "M": 16, "efConstruction": 200,
                           "efSearch": 100, "mode": "node"}, 10),
        },
    },
)
# the benchmark cell glove50.hnsw's deployment, timed in phase 6: the port's
# glove50_surrogate loader at glove-50-angular's 1,183,514 rows (256
# queries), cosine, GraphIndexer block mode at efSearch 200 (two waves)
GLOVE50 = {"rows": 1_183_514, "queries": 256, "k": 10, "efSearch": 200}
SURROGATE_CONFIG = {
    "name": "msmarco_surrogate",
    "source": ("configs/msmarco_surrogate.yaml hnsw (graph_cosine, ann_cosine), "
               "ivf_pq (ivf_pq_cosine), pq (pq_cosine), pq_refconfig (pq64_cosine); "
               "PQ rows with ann_cosine_highprobe"),
    "dataset": "msmarco_surrogate", "metric": "cosine", "n": 100_000, "d": 384,
    "topk": 20, "queries": 512, "batch": 512, "gt_k": 200, "repeat": 16,
    "rows": {
        "hnsw": ({"type": "GraphIndexer", "M": 16, "efConstruction": 200,
                  "efSearch": 100}, 10),
        "ivf_pq": ({"type": "FactoryIndexer", "index_key": "IVF256,PQ64",
                    "nprobe": 48}, 48),
        "pq": ({"type": "FactoryIndexer", "index_key": "PQ192"}, 48),
        "pq_refconfig": ({"type": "FactoryIndexer", "index_key": "PQ64"}, 48),
    },
}
# scripts/exp_manifold_rotations.py's manifold regime, as committed in
# benchmark_results/round5_rotations_ab/rotations_ab.json: the loader at its
# options there (d 384, 256 patches of rank 12, point scale 0.5), 100k rows,
# 256 queries, l2, top-20, IVF256,PQ64 np48 built without and with
# pq_rotations 'auto'
MANIFOLD_CONFIG = {
    "name": "manifold",
    "source": ("benchmark_results/round5_rotations_ab (scripts/exp_manifold_rotations.py, "
               "manifold regime: plain and auto rows)"),
    "dataset": "manifold", "metric": "l2", "n": 100_000, "d": 384, "topk": 20,
    "queries": 256, "batch": 256, "gt_k": 20,
    "dataset_options": {"dim": 384, "n_patches": 256, "intrinsic_dim": 12,
                        "point_scale": 0.5},
    "rows": {
        "plain": ({"type": "FactoryIndexer", "index_key": "IVF256,PQ64", "nprobe": 48,
                   "pq_rotations": 0}, 48),
        "auto": ({"type": "FactoryIndexer", "index_key": "IVF256,PQ64", "nprobe": 48,
                  "pq_rotations": "auto"}, 48),
    },
}
# configs/round5_faiss_lsh_refresh.yaml's faiss_lsh rows (BinaryLSHIndexer,
# 512 bits, top-20) and configs/round5_faiss_lsh_refresh_sift.yaml's, each
# with its dataset's options and its searcher's lsh_candidate_multiplier;
# "committed" is the JAX package's recall@20 for the row
# (benchmark_results/round5_faiss_lsh_refresh/faiss_lsh_refresh_20260820_233529
# and .../faiss_lsh_refresh_sift_20260821_002202). The SIFT row's repeat is
# the config's 32 cut to 4 for the run's time.
def _faiss_lsh_config(name, dataset, n, d, mult, committed, **kw):
    return dict({
        "name": f"faiss_lsh_{name}",
        "source": (f"configs/round5_faiss_lsh_refresh{'_sift' if dataset == 'sift1m' else ''}"
                   f".yaml faiss_lsh ({dataset}, lsh_candidate_multiplier {mult:g})"),
        "dataset": dataset, "metric": "l2", "n": n, "d": d, "topk": 20, "queries": 256,
        "batch": 256, "repeat": 32, "committed": committed,
        "rows": {"faiss_lsh": ({"type": "BinaryLSHIndexer", "num_bits": 512},
                               {"type": "ANNSearcher", "lsh_candidate_multiplier": mult})},
    }, **kw)


LSH_CONFIGS = (
    _faiss_lsh_config("random", "random", 20_000, 64, 128.0, 0.9918, test_size=512,
                      gt_k=200, seed=7),
    _faiss_lsh_config("glove50_surrogate", "glove50_surrogate", 20_000, 50, 512.0, 0.9984,
                      gt_k=200, seed=11),
    _faiss_lsh_config("sift1m_surrogate", "sift1m", SIFT_ROWS, 128, 64.0, 0.9898,
                      gt_k=20, repeat=4),
)
# configs/sift1m.yaml's rows on the surrogate must reach the JAX package's
# committed recall@100 less 0.03
# (benchmark_results/sift1m_20260818_224815/sift1m_results.json, 256
# queries; sift1m/config_used.yaml there holds each row's index_key and
# nprobe, as above); exact must be 1.0
SIFT_COMMITTED = {"ivf_flat": 0.9997, "ivf_sq8": 0.9978, "ivf_pq": 0.7994, "hnsw": 0.9919,
                  "exact": 1.0, "lsh": 1.0}
RECALL_MARGIN = 0.03
RUNNER_CONFIGS = IVF_CONFIGS + (SURROGATE_CONFIG, MANIFOLD_CONFIG) + LSH_CONFIGS
IVF_QUERIES = 2048
HOST_QUERIES = 64
# the host's Hamming scan over the 1M-row surrogate takes ~1.1 s a query
# (8 CPU cores): the card-against-host check of that row uses this many
HOST_QUERIES_1M_HAMMING = 16


def _ivf_dataset(cfg) -> dict:
    if cfg.get("dataset") == "sift1m":
        return {
            "name": "sift1m", "metric": cfg["metric"],
            "dataset_options": {"subdir": SIFT_SUBDIR, "test_size": cfg["queries"],
                                "ground_truth_k": cfg["gt_k"], "use_cache": False},
        }
    if cfg.get("dataset") == "glove50_surrogate":
        return {
            "name": "glove50_surrogate", "metric": cfg["metric"],
            "dataset_options": {"train_limit": cfg["n"], "test_size": cfg["queries"],
                                "ground_truth_k": cfg["gt_k"], "seed": cfg["seed"],
                                "use_cache": False},
        }
    if cfg.get("dataset") == "manifold":
        return {
            "name": "manifold", "metric": cfg["metric"],
            "dataset_options": dict(
                cfg["dataset_options"], train_limit=cfg["n"], test_size=cfg["queries"],
                ground_truth_k=cfg["gt_k"], use_cache=False),
        }
    if cfg.get("dataset") == "msmarco_surrogate":
        return {
            "name": "msmarco_surrogate", "metric": cfg["metric"],
            "dataset_options": {
                "train_limit": cfg["n"], "test_size": cfg["queries"],
                "ground_truth_k": cfg["gt_k"], "use_cache": False,
            },
        }
    return {
        "name": "random", "metric": cfg["metric"],
        "dataset_options": {
            "dimensions": cfg["d"], "train_size": cfg["n"],
            "test_size": cfg.get("test_size", IVF_QUERIES),
            "ground_truth_k": cfg.get("gt_k", cfg["topk"]),
            "seed": cfg.get("seed", SEED), "use_cache": False,
        },
    }


def _ivf_runner_config(cfg) -> dict:
    metric = cfg["metric"]
    indexers, searchers, algorithms = {}, {}, {}
    for row, (indexer, searcher) in cfg["rows"].items():
        indexers[f"{row}_ix"] = dict(indexer, metric=metric)
        if not isinstance(searcher, dict):  # an ANNSearcher's nprobe
            searcher = {"type": "ANNSearcher", "nprobe": searcher}
        searchers[f"{row}_search"] = dict(searcher, metric=metric)
        algorithms[row] = {"indexer_ref": f"{row}_ix",
                           "searcher_ref": f"{row}_search", "metric": metric}
    return {
        "indexers": indexers, "searchers": searchers, "algorithms": algorithms,
        "datasets": [_ivf_dataset(cfg)],
        "topk": cfg["topk"], "n_queries": cfg.get("queries", IVF_QUERIES),
        "query_batch_size": cfg.get("batch", BATCH), "repeat": cfg.get("repeat", 1),
        "output_dir": os.path.join(OUT_DIR, "runs"),
        "data_dir": _data_dir(cfg), "output_prefix": cfg["name"], "seed": 42,
    }


def _data_dir(cfg) -> str:
    """The runner's data_dir: the SIFT surrogate lies in ``_smoke_out/``."""
    return OUT_DIR if cfg.get("dataset") == "sift1m" else os.path.join(OUT_DIR, "data")


def _row_mode(algo) -> str:
    """K1's mode in an IVF row's search: u8 codes for SQ8, bf16 lists or
    bf16 reconstructions for Flat and PQ."""
    return "dist_blockmin_u8" if algo.artifact.kind == "ivf_sq8" else "dist_blockmin_bf16"


def _row_kernel(algo):
    """The kernel a row's timed search must launch (None: a node beam, the
    flat PQ scan or the LSH scans, which run no kernel of the repo; an LSH
    row's exact fallback launches dist_blockmin where rows fall short)."""
    kind = algo.artifact.kind
    if kind in ("pq", "lsh", "binary_lsh", "flat_sharded"):
        return None  # flat_sharded: plain products per shard, as in the JAX package
    if kind == "flat":
        return "dist_blockmin"
    if kind in _SHARDED_K1:  # f32 lists (IVF-Flat), u8 codes, bf16 reconstructions
        return _SHARDED_K1[kind]
    if kind == "graph_sharded":
        return "slab_dots" if algo.artifact.metadata.get("mode") == "block" else None
    if kind != "graph":
        return _row_mode(algo)
    return "slab_dots" if algo.artifact.metadata.get("mode") == "block" else None


def _row_builds_kmeans(algo) -> bool:
    """Whether a row's build runs k-means (and so launches assign)."""
    return algo.artifact.kind not in ("flat", "lsh", "binary_lsh", "flat_sharded")


def _lsh_row_line(algo, queries, k, bsz) -> dict:
    """An LSH row's own numbers: for multi-table LSH the rows answered by
    exact search (the fallback), for binary LSH the rerank path."""
    import torch

    from vectordb_retrieval_tpu_torch.models import lsh as lsh_models

    meta = algo.artifact.metadata
    q = torch.as_tensor(queries, device=DEV)
    if algo.artifact.kind == "lsh":
        s = algo.searcher
        short = sum(s._answer(q[i : i + bsz], k)[2] for i in range(0, len(q), bsz))
        cand = torch.cat([s.vote(s.hash_queries(q[i : i + bsz])[1], min(k, meta["n_vectors"]))
                          for i in range(0, len(q), bsz)])
        return {"phase": "lsh_main_path", "num_tables": meta["num_tables"],
                "hash_size": meta["hash_size"], "bucket_width": meta["bucket_width"],
                "candidate_multiplier": s.candidate_multiplier,
                "candidates": cand.shape[1], "colliding_candidates_share":
                    float((cand >= 0).float().mean()),
                "fallback_rows": short, "queries": len(q)}
    mult = float(algo.searcher.params.get("lsh_candidate_multiplier", 32.0))
    n_cand = lsh_models.binary_n_candidates(algo.artifact, k, mult)
    return {"phase": "binary_lsh_main_path", "num_bits": meta["num_bits"],
            "lsh_candidate_multiplier": mult, "candidates": n_cand,
            "rerank_path": lsh_models.binary_rerank_path(n_cand)}


def _dsub_launches(counts: dict, row: str, dsub: int) -> int:
    """assign launches of one row's build at d = dsub, K = 256: its PQ
    training (every subspace, every Lloyd step)."""
    return sum(n for key, n in counts.items()
               if key[0] == f"{row}/build" and key[1] == "assign" and key[3] == (KSUB, dsub))


def phase_runner_path(card: str, cfg, worst: dict) -> dict:
    """Drive the runner over one configuration's rows with the launch
    counts set to 0 just before and read just after; then hold every kernel
    launch against its plain version on its own inputs; keep each row's
    algorithm (artifact, searcher) and queries for the later phases."""
    import torch
    import yaml

    from vectordb_retrieval_tpu_torch.bench import experiment
    from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner
    from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
    from vectordb_retrieval_tpu_torch.ops import distances, kernels

    runners, builds, searches = [], {}, {}
    launched, stage, counts = {}, ["ground_truth"], {}
    orig_run = experiment.ExperimentRunner.run
    orig_build = CompositeAlgorithm.build_index
    orig_search = experiment.ExperimentRunner._timed_search

    def delta(before):
        return {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}

    def kept_run(self):
        out = orig_run(self)
        runners.append(self)
        return out

    def counted_build(self, vectors):
        before = dict(kernels.LAUNCHES)
        stage[0] = f"{self.name}/build"
        orig_build(self, vectors)
        stage[0] = "runner"
        builds[self.name] = delta(before)

    def counted_search(self, algorithm, *args, **kwargs):
        before = dict(kernels.LAUNCHES)
        stage[0] = f"{algorithm.name}/search"
        out = orig_search(self, algorithm, *args, **kwargs)
        stage[0] = "runner"
        searches[algorithm.name] = delta(before)
        return out

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{cfg['name']}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_ivf_runner_config(cfg), f)
    experiment.ExperimentRunner.run = kept_run
    CompositeAlgorithm.build_index = counted_build
    experiment.ExperimentRunner._timed_search = counted_search
    try:
        with capture_launch_inputs(launched, stage, counts=counts):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            devices = [DEV] * cfg["shards"] if "shards" in cfg else None  # a sharded mesh
            results = BenchmarkRunner(path, device=devices).run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
    finally:
        experiment.ExperimentRunner.run = orig_run
        CompositeAlgorithm.build_index = orig_build
        experiment.ExperimentRunner._timed_search = orig_search
    if cfg.get("shards") == SHARDED_TIMED_SHARDS:
        _time_captured_kernels(card, cfg["name"], launched, counts)
    check_launched(launched, cfg["name"], worst)

    ds_name = _ivf_dataset(cfg)["name"]
    ds = results[ds_name]
    if "error" in ds:
        raise AssertionError(f"{cfg['name']}: dataset error {ds['error']}")
    if cfg["n"] > distances._DENSE_PATH_MAX_ROWS and launches["dist_blockmin"] < 1:
        raise AssertionError(f"{cfg['name']}: ground truth did not launch dist_blockmin")
    runner = runners[-1]
    queries, gt = runner._select_query_subset()
    topk = cfg["topk"]
    rows = {}
    for row, (indexer, nprobe) in cfg["rows"].items():
        res = ds[row]
        if "error" in res:
            raise AssertionError(f"{cfg['name']}/{row}: row error {res['error']}")
        algo = runner.algorithms[row]
        kernel = _row_kernel(algo)
        b, s = builds.get(row, {}), searches.get(row, {})
        if _row_builds_kmeans(algo) and b.get("assign", 0) < 1:
            raise AssertionError(f"{cfg['name']}/{row}: the build did not launch assign")
        if kernel is not None and s.get(kernel, 0) < 1:
            raise AssertionError(f"{cfg['name']}/{row}: the timed search did not launch {kernel}")
        recall = res.get(f"recall@{topk}")
        if recall is None or not 0.0 <= recall <= 1.0:
            raise AssertionError(f"{cfg['name']}/{row}: recall@{topk} = {recall}")
        meta = algo.artifact.metadata
        pq_line = {}
        if algo.artifact.kind in ("pq", "ivf_pq"):
            dsub = meta["dimension"] // meta["m"]
            at_dsub = _dsub_launches(counts, row, dsub)
            if at_dsub < 1:
                raise AssertionError(f"{cfg['name']}/{row}: PQ training did not launch "
                                     f"assign at d = dsub = {dsub}")
            pq_line = {"m": meta["m"], "dsub": dsub, "assign_launches_at_dsub": at_dsub,
                       "build_seconds": dict(algo.indexer.build_seconds),
                       "pq_rot_auto": meta.get("pq_rot_auto"),
                       "rotations": "list_rotations" in algo.artifact.data}
        line = {
            "config": cfg["name"], "source": cfg["source"], "row": row,
            "shape": [cfg["n"], cfg["d"]], "metric": cfg["metric"], "card": card,
            f"recall@{topk}": recall, "qps": res["qps"],
            "build_time_s": res["build_time_s"],
            "index_memory_mb": res["index_memory_mb"],
            "launches_build": b, "launches_timed_search": s,
        }
        if algo.artifact.kind == "graph":
            line.update({
                "phase": "graph_main_path", "mode": meta.get("mode", "node"),
                "M": meta["M"], "degree": meta["degree"],
                "efSearch": meta["efSearch"],
                "selfcheck_recall": meta.get("selfcheck_recall"),
            })
            if meta.get("mode") == "block":
                line.update({
                    "n_blocks": meta["n_blocks"], "block_len": meta["block_len"],
                    "n_entries": meta["n_entries"], "slab_dtype": meta["slab_dtype"],
                })
            else:
                line["nbr_table"] = meta["nbr_table"]
            line["slab_dots_launches"] = b.get("slab_dots", 0) + s.get("slab_dots", 0)
        elif algo.artifact.kind == "pq":
            line.update({"phase": "pq_main_path", "index_key": meta["index_key"]})
        elif algo.artifact.kind.endswith("_sharded"):
            line.update(_sharded_row_line(algo, cfg.get("batch", BATCH)))
        elif algo.artifact.kind in ("lsh", "binary_lsh"):
            line.update(_lsh_row_line(algo, queries, min(topk, cfg["n"]), cfg.get("batch", BATCH)))
        elif algo.artifact.kind == "flat":
            rel = _check_gt_float64(runner.dataset.train_vectors, queries, gt, cfg["metric"],
                                    k=topk)
            line.update({"phase": "exact_main_path", "gt_float64_max_rel_err": rel,
                         "gt_float64_tol": GT_REL_TOL})
            if rel > GT_REL_TOL:
                raise AssertionError(f"{cfg['name']}/{row}: ground truth vs float64 rel err {rel}")
        else:
            line.update({
                "phase": "ivf_main_path", "index_key": meta["index_key"],
                "nprobe": nprobe, "n_buckets": meta["n_buckets"],
                "bucket_len": meta["max_list_len"],
                "slots": meta["n_buckets"] * meta["max_list_len"],
                "pad_ratio": meta["pad_ratio"],
            })
        line.update(pq_line)
        emit(line)
        rows[row] = {"algo": algo, "queries": queries, "gt": gt, "k": min(topk, cfg["n"]),
                     "batch": cfg.get("batch", BATCH), "recall": recall, "qps": res["qps"]}
    if cfg is SURROGATE_CONFIG:
        meta = rows["hnsw"]["algo"].artifact.metadata
        recall = ds["hnsw"][f"recall@{topk}"]
        if meta.get("mode") != "block" or recall < GRAPH_MIN_RECALL:
            raise AssertionError(
                f"msmarco_surrogate/hnsw: mode {meta.get('mode')}, self-check "
                f"{meta.get('selfcheck_recall')}, recall@{topk} {recall}")
        got = {row: ds[row][f"recall@{topk}"] for row in PQ_RECALL_FLOORS}
        ok = all(got[row] >= floor for row, floor in PQ_RECALL_FLOORS.items())
        emit({"phase": "pq_recall_gate", "config": cfg["name"], f"recall@{topk}": got,
              "floors": PQ_RECALL_FLOORS, "card": card, "ok": ok})
        if not ok:
            raise AssertionError(f"msmarco_surrogate PQ rows below their floors: {got}")
    if cfg is MANIFOLD_CONFIG:
        rec = rows["auto"]["algo"].artifact.metadata.get("pq_rot_auto") or {}
        plain, auto = (ds[row][f"recall@{topk}"] for row in ("plain", "auto"))
        ok = bool(rec.get("enabled")) and auto >= plain + ROT_AB_MIN_RECALL_GAIN
        emit({"phase": "rotations_ab", "config": cfg["name"], "plain": plain, "auto": auto,
              "pq_rot_auto": rec, "min_recall_gain": ROT_AB_MIN_RECALL_GAIN,
              "jax_committed": {"plain": 0.5604, "auto": 0.7854, "gain": 0.6877},
              "card": card, "ok": ok})
        if not ok:
            raise AssertionError(f"manifold A/B: plain {plain}, auto {auto}, {rec}")
    if cfg is IVF_CONFIGS[0] or cfg in LSH_CONFIGS or cfg in SHARDED_CONFIGS:
        _recall_gate(card, cfg, ds, runner)
    emit({"phase": "main_path_run", "config": cfg["name"], "card": card,
          "runner_seconds": seconds, "launches": launches})
    out = {"name": cfg["name"], "launches": launches, "rows": rows, "counts": counts}
    if cfg.get("dataset") == "sift1m":  # integer rows: exact ties (card vs host)
        out["train"] = runner.dataset.train_vectors
    return out


def _k1_numbers(q, x, pen, w) -> dict:
    """K1 on one launch's inputs: the kernel, its plain version, one
    library product (the f32 mode in FP32 with TF32 off, the bf16 / u8
    modes as a bf16 product of the widened payload) and the card's bound."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    ms = time_ms(lambda: kernels.dist_blockmin(q, x, pen, w=w), prime=True)
    plain_ms = time_ms(lambda: kernels.dist_blockmin_reference(q, x, pen, w=w),
                       reps=5, warmup=1)
    if x.dtype == torch.float32:
        library_ms = time_ms(lambda: torch.matmul(q, x.T), reps=10)
    else:
        qb, xb = q.to(torch.bfloat16), x.to(torch.bfloat16)  # outside the clock
        library_ms = time_ms(lambda: torch.matmul(qb, xb.T), reps=10)
        del xb
    (b, d), s_rows = q.shape, x.shape[0]
    flops, nbytes = kernels.dist_blockmin_work(b, s_rows, d, w, x.dtype)
    if x.dtype == torch.float32:
        bounds = _tf32x3_bounds(2.0 * b * s_rows * d, flops, nbytes)
    else:
        flop_ms = flops / BF16_PEAK_FLOPS * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bounds = {"bound_ms": max(flop_ms, byte_ms),
                  "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bounds,
            "flops": flops, "bytes": nbytes, "shape": [b, s_rows, d, w]}


def _assign_numbers(p, c) -> dict:
    """K3 on one launch's inputs: kernel, plain version, one FP32 library
    product (TF32 off) and the bounds of its 3xTF32 route."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    ms = time_ms(lambda: kernels.assign(p, c), reps=10, prime=True)
    plain_ms = time_ms(lambda: kernels.assign_reference(p, c), reps=3, warmup=1)
    library_ms = time_ms(lambda: torch.matmul(p, c.T), reps=10)
    (n, d), k = p.shape, c.shape[0]
    flops, nbytes = kernels.assign_work(n, k, d)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **_tf32x3_bounds(2.0 * n * k * d, flops, nbytes), "flops": flops,
            "bytes": nbytes, "shape": [n, k, d]}


# the row-sharded kernels are timed on the launches of this mesh's run
SHARDED_TIMED_SHARDS = 4


def _time_captured_kernels(card: str, name: str, store: dict, counts: dict) -> None:
    """Each kernel mode at each per-shard shape of a row-sharded run, timed
    on the inputs of its last launch there (K1 and K2 in the timed
    searches, K3 in the builds, each distinct shape once), with its plain
    version, one library call and the card's bound; ``launches`` are the
    run's calls at that key."""
    t0 = time.perf_counter()
    entries, seen = [], set()
    for key, args in store.items():
        stage, kname = key[0], key[1]
        if key[1:] in seen or kname == PAIR:
            continue
        if kname == "assign" and stage.endswith("/build"):
            nums = _assign_numbers(*args)
        elif kname == "slab_dots" and stage.endswith("/search"):
            nums = _slab_dots_numbers(*args)
            nums = {"ms": nums.pop("slab_dots_ms"), **nums}
        elif kname in _MODE_NAME.values() and stage.endswith("/search"):
            nums = _k1_numbers(*args)
        else:
            continue
        seen.add(key[1:])
        calls = sum(n for k, n in counts.items() if k[1:] == key[1:])
        entries.append({"name": kname, "stage": stage, "launches": calls,
                        "dtype": str(args[1].dtype).replace("torch.", ""),
                        **{k: nums[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                "bound_ms", "bound_by", "flops", "bytes")}})
    emit({"phase": "sharded_kernels", "config": name, "card": card, "kernels": entries,
          "seconds": time.perf_counter() - t0})


def _recall_gate(card: str, cfg, ds, runner) -> None:
    """The SIFT surrogate's rows (unsharded and row-sharded) and the
    faiss_lsh rows against the JAX package's committed recall less
    RECALL_MARGIN (exact: 1.0)."""
    topk = cfg["topk"]
    if cfg is IVF_CONFIGS[0]:
        committed = SIFT_COMMITTED
    elif cfg in SHARDED_CONFIGS:
        committed = {row: SIFT_COMMITTED[row] for row in cfg["rows"]}
    else:
        committed = {"faiss_lsh": cfg["committed"]}
    got = {row: ds[row][f"recall@{topk}"] for row in committed}
    floors = {row: (1.0 if row == "exact" else c - RECALL_MARGIN) for row, c in committed.items()}
    ok = all(got[row] >= floors[row] for row in committed)
    emit({"phase": "recall_gate", "config": cfg["name"], "source": cfg["source"],
          f"recall@{topk}": got, "committed": committed, "floors": floors,
          "surrogate": runner.dataset.metadata.get("surrogate"),
          "surrogate_for": runner.dataset.metadata.get("surrogate_for"),
          "card": card, "ok": ok})
    if not ok:
        raise AssertionError(f"{cfg['name']}: rows below their floors: {got} < {floors}")


def _ivf_stages(info):
    """The fused IVF search of one row, cut into its stages, on the row's
    first batch of queries: the inputs each stage takes on the main path.
    An IVF-PQ row's first stage decodes every list (the resident regime)."""
    import types

    import torch

    from vectordb_retrieval_tpu_torch.ops import distances as dops
    from vectordb_retrieval_tpu_torch.ops import ivf

    algo = info["algo"]
    searcher, art = algo.searcher, algo.artifact
    d, meta = art.data, art.metadata
    if "full_vectors" in d:
        raise AssertionError("the stage split covers rows without exact_rescore")
    q_raw = torch.as_tensor(info["queries"][: info["batch"]], device=DEV)
    q = dops.normalize(q_raw) if meta.get("normalize_queries") else q_raw
    if d.get("opq_rotation") is not None:
        q = q @ d["opq_rotation"]
    metric = searcher._score_metric()
    slot_ids = d["slot_ids"]
    n_bkt, L = slot_ids.shape
    if ivf.ivf_route(info["batch"], searcher._nprobe(), n_bkt, L) != "fused_k1":
        raise AssertionError(f"layout {n_bkt} x {L} does not take the fused stream")
    w = ivf._fused_w(L)
    decode = None
    if art.kind == "ivf_flat":
        coding = ivf.ListCoding(d["list_vecs"], d["list_sqnorms"], q)
    elif art.kind == "ivf_pq":
        dim = d["centroids"].shape[1]
        if n_bkt * L * dim * 2 > ivf._IVFPQ_RESIDENT_BUDGET:
            raise AssertionError(f"{n_bkt} x {L} x {dim} is past the resident budget")
        rots = d.get("list_rotations")

        def decode():
            return ivf.decode_resident(d["list_codes"], d["centroids"], d["codebooks"], rots,
                                       None if rots is None else d["bucket_lists"])

        coding = ivf.ListCoding(*decode(), q)
    else:
        coding = ivf.ListCoding(d["list_codes"], d["list_sqnorms"], q, vmin=d["vmin"],
                                step=d["step"])
    pen = ivf._fused_pen(slot_ids, coding.sqnorms, metric)
    budget = searcher._nprobe()
    pk = searcher._probe_kwargs()
    if pk:
        def coarse():
            return ivf.exact_probe_mask(
                q, d["centroids"], pk["bucket_lists"], pk["nlist"],
                pk["nprobe_lists"], budget, list_centroids=pk.get("list_centroids"))
    else:
        def coarse():
            return ivf._coarse_probes(q, d["centroids"], budget), None
    return types.SimpleNamespace(
        q_raw=q_raw, q=q, qk=coding.index_queries(), payload=coding.rows.reshape(n_bkt * L, -1),
        pen=pen.reshape(-1, w), w=w, metric=metric, n_bkt=n_bkt, bpb=L // w, slot_ids=slot_ids,
        coding=coding, scorer=ivf._block_scorer(coding, slot_ids, w, metric), coarse=coarse,
        decode=decode, k=min(info["k"], meta["n_vectors"]), searcher=searcher,
    )


def _reconstruction_classes(art):
    """For a PQ or IVF-PQ artifact, each row's class of bit-identical
    reconstructions: the lowest row id with the same codes (IVF-PQ: the
    same codes in the same list). Such rows have equal distances to every
    query on either device, so which of them fills a top-k's last places is
    the top-k's tie order, unspecified. None for other kinds."""
    import numpy as np

    d = art.data
    if art.kind == "pq":
        codes = d["codes"].cpu().numpy()
        rows = np.arange(codes.shape[0])
        lists = np.zeros(codes.shape[0], np.int64)
    elif art.kind == "ivf_pq":
        slots = d["slot_ids"].cpu().numpy()
        live = slots.reshape(-1) >= 0
        rows = slots.reshape(-1)[live]
        codes = d["list_codes"].cpu().numpy().reshape(slots.size, -1)[live]
        lists = np.repeat(d["bucket_lists"].cpu().numpy().astype(np.int64), slots.shape[1])[live]
    else:
        return None
    key = np.concatenate([lists[:, None].view(np.uint8).reshape(len(rows), -1), codes], axis=1)
    key = np.ascontiguousarray(key).view(f"V{key.shape[1]}").ravel()
    _, inverse = np.unique(key, return_inverse=True)
    lowest = np.full(inverse.max() + 1, np.iinfo(np.int64).max)
    np.minimum.at(lowest, inverse, rows)
    canon = np.empty(art.metadata["n_vectors"], np.int64)
    canon[rows] = lowest[inverse]
    return canon


def _recall(ids, gt, k) -> float:
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k for a, b in zip(ids, gt)]))


def _distance_classes(train, q, ci, hi):
    """Ids as their exact squared distances to the query (float64 sums of
    the integer rows' squares, exact): rows at one distance form a class,
    and which of them fills a top-k's last places is the top-k's tie
    order. Returns the card's and the host's classes."""
    q64 = q.astype(np.float64)

    def dist(ids):
        rows = train[np.maximum(ids, 0)].astype(np.float64)
        return np.where(ids >= 0, ((rows - q64[:, None, :]) ** 2).sum(-1), -1.0)

    return dist(ci), dist(hi)


def _multiset_agreement(ci, hi, k):
    """Per query, the share of entries the two lists have in common, as
    multisets: ``(mean share, per-query equality)``."""
    share, same = [], []
    for a, b in zip(ci, hi):
        common = collections.Counter(a.tolist()) & collections.Counter(b.tolist())
        share.append(sum(common.values()) / k)
        same.append(sorted(a.tolist()) == sorted(b.tolist()))
    return float(np.mean(share)), same


def _host_searcher(algo):
    """The row's searcher on the CPU, over a host copy of its artifact (the
    kernels' plain versions); the cover tree runs the block walk there, as
    the card does; a row-sharded artifact is placed over as many CPU
    devices as it has shards."""
    import torch

    from vectordb_retrieval_tpu_torch.models.base import IndexArtifact
    from vectordb_retrieval_tpu_torch.models.covertree import CoverTree
    from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher
    from vectordb_retrieval_tpu_torch.models.lsh import LSHSearcher

    art = algo.artifact
    if art.kind.endswith("_sharded"):  # the stacked arrays, placed over as many CPU devices
        host_art = IndexArtifact(art.kind, {k: torch.as_tensor(np.asarray(v))
                                            for k, v in art.data.items()}, dict(art.metadata))
        host = ANNSearcher(metric=algo.searcher.metric, device=["cpu"] * art.mesh.size("db"),
                           **algo.searcher.params)
        host.attach(host_art)
        return host, algo.searcher.batch_search
    host_art = IndexArtifact(art.kind, {k: v.cpu() for k, v in art.data.items()}, dict(art.metadata))
    if art.kind == "covertree":
        host = CoverTree(algo.dimension, metric=algo.metric, err_c=algo.err_c,
                         descent="blockwalk", device="cpu")
        host.artifact, host.is_built = host_art, True
        return host, algo.batch_search
    s = algo.searcher
    if art.kind == "lsh":
        host = LSHSearcher(
            metric=s.metric, device="cpu", candidate_multiplier=s.candidate_multiplier,
            fallback_to_bruteforce=s.fallback_to_bruteforce, **s.params)
    else:
        host = ANNSearcher(metric=s.metric, device="cpu", **s.params)
    host.attach(host_art)
    return host, s.batch_search


def phase_card_vs_host(card: str, paths) -> None:
    """Each built artifact copied to the CPU and searched there by the port
    (the kernels' plain versions) for 64 queries (16 for a 1M-row Hamming
    scan), against the card. PQ rows compare ids modulo bit-identical
    reconstructions (:func:`_reconstruction_classes`), the SIFT surrogate's
    other rows modulo exact distance ties (:func:`_distance_classes`: its
    rows are integers); the plain agreement is printed beside it. LSH rows
    also hold the card's recall to the host's."""
    for path in paths:
        for row, info in path["rows"].items():
            algo = info["algo"]
            art = algo.artifact
            host, card_search = _host_searcher(algo)
            n = art.metadata["n_vectors"]
            n_q = HOST_QUERIES_1M_HAMMING if art.kind == "binary_lsh" and n >= 1_000_000 else HOST_QUERIES
            q = info["queries"][:n_q]
            k = info["k"]
            t0 = time.perf_counter()
            hd, hi = host.batch_search(q, k)
            host_s = time.perf_counter() - t0
            cd, ci = card_search(q, k)
            raw_agree, raw_same = _multiset_agreement(ci, hi, k)
            canon = _reconstruction_classes(art)
            if canon is not None:  # classes as multisets: a top-k may hold several rows of one
                classes = "identical_reconstructions"
                agree, same = _multiset_agreement(
                    *(np.where(ids >= 0, canon[np.maximum(ids, 0)], -1) for ids in (ci, hi)), k)
            elif "train" in path:
                classes = "equal_distances"
                agree, same = _multiset_agreement(*_distance_classes(path["train"], q, ci, hi), k)
            else:
                classes, agree, same = None, raw_agree, raw_same
            lsh = art.kind in ("lsh", "binary_lsh")
            graph = art.kind in ("graph", "graph_sharded")
            min_agree = (GRAPH_HOST_MIN_AGREE if graph
                         else LSH_HOST_MIN_AGREE if lsh else HOST_MIN_AGREE)
            # distances on the queries whose id sets agree (all of them for
            # the exact, IVF and PQ rows, which must agree on >= 99.9 %)
            rows_ok = np.asarray(same) if graph or lsh else np.ones(len(q), bool)
            scale = float(np.abs(hd[np.isfinite(hd)]).max())
            cs, hs = np.sort(cd, 1), np.sort(hd, 1)
            diff = np.where(np.isinf(cs) & (cs == hs), 0.0, np.abs(cs - hs))  # padding: inf in both
            err = float(diff[rows_ok].max()) if rows_ok.any() else 0.0
            recalls = {"card": _recall(ci, info["gt"], k), "host": _recall(hi, info["gt"], k)}
            ok = agree >= min_agree and err <= HOST_REL_TOL * scale
            if lsh:
                ok = ok and abs(recalls["card"] - recalls["host"]) <= LSH_HOST_RECALL_TOL
            emit({"phase": "card_vs_host", "config": path["name"], "row": row,
                  "kind": art.kind, "queries": len(q), "k": k, "id_agreement": agree,
                  "modulo": classes,
                  "largest_identical_class": None if canon is None else int(np.bincount(canon).max()),
                  "raw_id_agreement": raw_agree,
                  "queries_with_equal_ids": int(np.sum(raw_same)),
                  "queries_equal_modulo_classes": int(np.sum(same)),
                  "min_agreement": min_agree, "max_abs_dist_err": err,
                  "tol": HOST_REL_TOL * scale, "recall_on_these_queries": recalls,
                  "recall_tol": LSH_HOST_RECALL_TOL if lsh else None,
                  "host_seconds": host_s, "card": card, "ok": ok})
            if not ok:
                raise AssertionError(
                    f"card vs host {path['name']}/{row}: agreement {agree}, err {err}, "
                    f"recalls {recalls}")


def phase_persistence_round_trip(card: str, cfg, row: str) -> None:
    """build_only then retrieve_only of one row on the card: the loaded
    index returns the built index's ids exactly."""
    import numpy as np
    import torch

    from vectordb_retrieval_tpu_torch.bench import experiment
    from vectordb_retrieval_tpu_torch.bench.config import ExperimentConfig

    spec = cfg["rows"][row]
    if isinstance(spec, dict):  # a registry algorithm (the cover tree)
        algo_cfg = dict(spec)
    else:
        indexer, nprobe = spec
        algo_cfg = {"indexer": dict(indexer), "metric": cfg["metric"],
                    "searcher": {"type": "ANNSearcher", "nprobe": nprobe}}
    ds = _ivf_dataset(cfg)
    art_dir = os.path.join(OUT_DIR, "artifacts")
    batch = cfg.get("batch", BATCH)

    def config(mode):
        return ExperimentConfig(
            dataset=ds["name"], data_dir=os.path.join(OUT_DIR, "data"),
            dataset_options=ds["dataset_options"], metric=cfg["metric"],
            n_queries=cfg.get("queries", IVF_QUERIES), topk=cfg["topk"],
            query_batch_size=batch,
            algorithms={row: dict(algo_cfg, persistence={
                "enabled": True, "mode": mode, "artifact_dir": art_dir,
                "force_rebuild": True})},
        )

    seen = []
    orig_search = experiment.ExperimentRunner._timed_search

    def kept_search(self, *args, **kwargs):
        out = orig_search(self, *args, **kwargs)
        seen.append(out[0])
        return out

    built = experiment.ExperimentRunner(config("build_only"),
                                        output_dir=os.path.join(OUT_DIR, "rt_build"))
    res_b = built.run()[row]
    if res_b.get("status") != "build_only":
        raise AssertionError(f"build_only row: {res_b}")
    experiment.ExperimentRunner._timed_search = kept_search
    try:
        loaded = experiment.ExperimentRunner(
            config("retrieve_only"), output_dir=os.path.join(OUT_DIR, "rt_load"))
        res_l = loaded.run()[row]
    finally:
        experiment.ExperimentRunner._timed_search = orig_search
    if "error" in res_l or res_l.get("index_source") != "loaded" or len(seen) != 1:
        raise AssertionError(f"retrieve_only row: {res_l}")
    algo = built.algorithms[row]
    queries, _ = loaded._select_query_subset()
    q = torch.as_tensor(queries, device=DEV)
    k = cfg["topk"]
    direct = torch.cat([algo.device_kernel(q[s : s + batch], k)[1]
                        for s in range(0, len(queries), batch)]).cpu().numpy()
    same = bool(np.array_equal(direct, seen[0][:, :k]))
    emit({"phase": "persistence_round_trip", "config": cfg["name"], "row": row,
          "kind": algo.artifact.kind, "mode": algo.artifact.metadata.get("mode"),
          "persist_dir": res_b["persist_dir"], "index_source": res_l["index_source"],
          "index_load_time_s": res_l["index_load_time_s"],
          f"recall@{k}": res_l[f"recall@{k}"], "ids_identical": same, "card": card})
    if not same:
        raise AssertionError(f"{cfg['name']}/{row}: retrieve_only ids differ from the built index's")
    del built, loaded, algo
    torch.cuda.empty_cache()


# ---- 5c. cover-tree path --------------------------------------------------

# The four CoverTreeV2_2 rows of configs/covertree_refresh.yaml: the MS
# MARCO MiniLM shape, the file's random row, its glove50_surrogate row and
# its sift1m row on the SIFT1M surrogate (1M rows, uncut: the build takes
# about 35 s on one H100 80GB HBM3, PERF.md, under the 300 s past which the
# loader's base_limit would cut the row).
COVERTREE_CONFIGS = (
    {
        "name": "covertree_msmarco",
        "source": "configs/covertree_refresh.yaml msmarco_surrogate (CoverTreeV2_2)",
        "dataset": "msmarco_surrogate", "metric": "cosine", "n": 100_000, "d": 384,
        "topk": 20, "queries": 512, "batch": 512, "gt_k": 200, "repeat": 16,
        "rows": {"covertree_v2_2": {"type": "CoverTreeV2_2", "metric": "cosine"}},
    },
    {
        "name": "covertree_random",
        "source": "configs/covertree_refresh.yaml random (CoverTreeV2_2)",
        "metric": "l2", "n": 20_000, "d": 64, "topk": 20, "queries": 256,
        "batch": 256, "test_size": 512, "gt_k": 200, "repeat": 16,
        "rows": {"covertree_v2_2": {"type": "CoverTreeV2_2", "metric": "l2"}},
    },
    {
        "name": "covertree_glove50_surrogate",
        "source": "configs/covertree_refresh.yaml glove50_surrogate (CoverTreeV2_2)",
        "dataset": "glove50_surrogate", "metric": "l2", "n": 20_000, "d": 50, "topk": 20,
        "queries": 256, "batch": 256, "gt_k": 200, "seed": 11, "repeat": 16,
        "rows": {"covertree_v2_2": {"type": "CoverTreeV2_2", "metric": "l2"}},
    },
    {
        "name": "covertree_sift1m_surrogate",
        "source": "configs/covertree_refresh.yaml sift1m (CoverTreeV2_2, subdir sift1m_synth)",
        "dataset": "sift1m", "metric": "l2", "n": SIFT_ROWS, "d": 128, "topk": 100,
        "queries": 256, "batch": 256, "gt_k": 100, "repeat": 8,
        "rows": {"covertree_v2_2": {"type": "CoverTreeV2_2", "metric": "l2"}},
    },
)
# the forced fallback's tree: over exact search's dense-path limit (32,768
# rows), so its exact search launches dist_blockmin f32
FALLBACK_SHAPE = (40_000, 16)
FALLBACK_ERR_C = 10.0
# block walk vs stream walk on one artifact: sorted distances within this
# relative tolerance (both rescore exactly; they may select other blocks)
WALKS_RTOL = 1e-4


def _ct_runner_config(cfg) -> dict:
    return {
        "algorithms": {row: dict(spec, repeat=cfg["repeat"]) for row, spec in cfg["rows"].items()},
        "datasets": [_ivf_dataset(cfg)],
        "topk": cfg["topk"], "n_queries": cfg["queries"],
        "query_batch_size": cfg["batch"], "repeat": cfg["repeat"],
        "output_dir": os.path.join(OUT_DIR, "runs"),
        "data_dir": _data_dir(cfg), "output_prefix": cfg["name"], "seed": 42,
    }


def _ct_queries(algo, queries):
    import torch

    from vectordb_retrieval_tpu_torch.ops import distances as dops

    q = torch.as_tensor(queries, device=DEV)
    return dops.normalize(q) if algo.metric == "cosine" else q


def phase_covertree_path(card: str, cfg, worst: dict) -> dict:
    """One cover-tree row through the BenchmarkRunner with the launch counts
    set to 0 just before and read just after: exact recall, the block walk
    and its one dist_blockmin_pair launch (counted under
    dist_blockmin_bf16) per batch; then every launch held against its plain
    version on its own inputs (the pair on both pens)."""
    import torch
    import yaml

    from vectordb_retrieval_tpu_torch.bench import experiment
    from vectordb_retrieval_tpu_torch.bench.runner import BenchmarkRunner
    from vectordb_retrieval_tpu_torch.models.covertree import CoverTree
    from vectordb_retrieval_tpu_torch.ops import kernels

    runners, builds, searches = [], {}, {}
    launched, stage, pairs = {}, ["ground_truth"], [0]
    orig_run = experiment.ExperimentRunner.run
    orig_build = CoverTree.build_index
    orig_search = experiment.ExperimentRunner._timed_search

    def delta(before):
        return {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}

    def kept_run(self):
        out = orig_run(self)
        runners.append(self)
        return out

    def counted_build(self, vectors):
        before = dict(kernels.LAUNCHES)
        stage[0] = f"{self.name}/build"
        orig_build(self, vectors)
        stage[0] = "runner"
        builds[self.name] = delta(before)

    def counted_search(self, algorithm, *args, **kwargs):
        before = dict(kernels.LAUNCHES)
        stage[0] = f"{algorithm.name}/search"
        out = orig_search(self, algorithm, *args, **kwargs)
        stage[0] = "runner"
        searches[algorithm.name] = delta(before)
        return out

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"{cfg['name']}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_ct_runner_config(cfg), f)
    experiment.ExperimentRunner.run = kept_run
    CoverTree.build_index = counted_build
    experiment.ExperimentRunner._timed_search = counted_search
    try:
        with capture_launch_inputs(launched, stage, pairs):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            results = BenchmarkRunner(path).run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
    finally:
        experiment.ExperimentRunner.run = orig_run
        CoverTree.build_index = orig_build
        experiment.ExperimentRunner._timed_search = orig_search
    n_checked = len(launched)
    check_launched(launched, cfg["name"], worst)
    if launches["dist_blockmin_bf16"] != pairs[0]:
        raise AssertionError(f"{cfg['name']}: {launches['dist_blockmin_bf16']} bf16 launches, "
                             f"{pairs[0]} of them pairs: the block walk launches only the pair")

    ds = results[_ivf_dataset(cfg)["name"]]
    if "error" in ds:
        raise AssertionError(f"{cfg['name']}: dataset error {ds['error']}")
    runner = runners[-1]
    queries, gt = runner._select_query_subset()
    topk, bsz = cfg["topk"], cfg["batch"]
    rows = {}
    for row in cfg["rows"]:
        res = ds[row]
        if "error" in res:
            raise AssertionError(f"{cfg['name']}/{row}: row error {res['error']}")
        algo = runner.algorithms[row]
        recall = res.get(f"recall@{topk}")
        if recall != 1.0:
            raise AssertionError(f"{cfg['name']}/{row}: recall@{topk} = {recall}")
        b, s = builds.get(row, {}), searches.get(row, {})
        batches = -(-len(queries) // bsz)
        calls = 1 + cfg["repeat"] * batches  # the warm-up batch + the timed passes
        if not algo.uses_blockwalk() or s.get("dist_blockmin_bf16") != calls:
            raise AssertionError(
                f"{cfg['name']}/{row}: block walk {algo.uses_blockwalk()}, "
                f"dist_blockmin_pair launches {s.get('dist_blockmin_bf16')} != {calls}")
        k = min(topk, cfg["n"])
        q = _ct_queries(algo, queries)
        overflowed = sum(int(algo._search(q[i : i + bsz], k).overflow.sum())
                         for i in range(0, len(queries), bsz))
        prep = algo.blockwalk_prep()
        meta = algo.artifact.metadata
        emit({
            "phase": "covertree_main_path", "config": cfg["name"],
            "source": cfg["source"], "row": row, "shape": [cfg["n"], cfg["d"]],
            "metric": cfg["metric"], "card": card, f"recall@{topk}": recall,
            "qps": res["qps"], "build_time_s": res["build_time_s"],
            "build_seconds": algo.build_seconds, "n_nodes": meta["n_nodes"],
            "depths": len(meta["depth_sizes"]), "max_depth_width": max(meta["depth_sizes"]),
            "w": prep.w, "index_memory_mb": res["index_memory_mb"],
            "index_bytes": algo.artifact.device_nbytes(), "prep_bytes": prep.nbytes(),
            "fallback_rows_bytes": sum(t.numel() * t.element_size()
                                       for t in algo._derived.get("rows", ())),
            "ndis_per_query": res.get("operations_per_query"),
            "queries": len(queries), "overflowed_queries": overflowed,
            "launches_build": b, "launches_timed_search": s,
            "dist_blockmin_pair_per_batch": s["dist_blockmin_bf16"] / calls,
            "launch_inputs_checked": n_checked,
        })
        rows[row] = {"algo": algo, "queries": queries, "gt": gt, "k": k, "batch": bsz,
                     "recall": recall}
    emit({"phase": "main_path_run", "config": cfg["name"], "card": card,
          "runner_seconds": seconds, "launches": launches})
    out = {"name": cfg["name"], "launches": launches, "rows": rows}
    if cfg.get("dataset") == "sift1m":  # integer rows: exact ties (card vs host)
        out["train"] = runner.dataset.train_vectors
    return out


def phase_covertree_walks(card: str, info) -> None:
    """The block walk and the stream walk over one artifact on the card:
    the same sorted distances from the search (each walk's flagged rows
    answered by exact search), and the same raw distances on the rows that
    both walks certified."""
    import torch

    algo, k, bsz = info["algo"], info["k"], info["batch"]
    q_raw = torch.as_tensor(info["queries"], device=DEV)
    q = _ct_queries(algo, q_raw)
    out = {}
    try:
        for descent in ("blockwalk", "stream"):
            algo.descent = descent
            raw = [algo._search(q[i : i + bsz], k) for i in range(0, len(q), bsz)]
            exact = [algo.device_kernel(q_raw[i : i + bsz], k)[0] for i in range(0, len(q), bsz)]
            out[descent] = (torch.cat([r.dists for r in raw]), torch.cat([r.overflow for r in raw]),
                            float(sum(int(r.ndis.sum()) for r in raw)) / len(q),
                            torch.cat(exact).sort(dim=1).values)
    finally:
        algo.descent = "auto"
    (rb, ob, nb, eb), (rs, os_, ns, es) = out["blockwalk"], out["stream"]

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-12)).max()) if a.numel() else 0.0

    both = ~(ob | os_)
    rel_search = rel(eb, es)
    rel_certified = rel(rb[both].sort(dim=1).values, rs[both].sort(dim=1).values)
    ok = rel_search <= WALKS_RTOL and rel_certified <= WALKS_RTOL
    emit({"phase": "covertree_walks", "card": card, "queries": len(q), "k": k,
          "max_rel_diff": rel_search, "max_rel_diff_certified": rel_certified,
          "rtol": WALKS_RTOL, "overflowed_blockwalk": int(ob.sum()),
          "overflowed_stream": int(os_.sum()), "certified_by_both": int(both.sum()),
          "ndis_per_query_blockwalk": nb, "ndis_per_query_stream": ns, "ok": ok})
    if not ok:
        raise AssertionError(f"block walk vs stream walk: rel {rel_search}, "
                             f"certified rows {rel_certified}")


def phase_covertree_fallback(card: str) -> dict:
    """A tree searched with an absurd band: every certificate fails, the
    batch is answered by exact search (dist_blockmin f32) and stays exact.
    Returns the launches of the run (counts set to 0 just before)."""
    import torch

    from vectordb_retrieval_tpu_torch.models import get_algorithm_instance
    from vectordb_retrieval_tpu_torch.ops import kernels

    n, d = FALLBACK_SHAPE
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((n, d), dtype=np.float32)
    qn = rng.standard_normal((HOST_QUERIES, d), dtype=np.float32)
    algo = get_algorithm_instance("covertree", d, err_c=FALLBACK_ERR_C)
    algo.build_index(x)
    q = torch.as_tensor(qn, device=DEV)
    kernels.reset_launch_counts()
    flagged = int(algo._search(q, TOPK).overflow.sum())
    dist, ids = algo.device_kernel(q, TOPK)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    xd = torch.as_tensor(x, device=DEV, dtype=torch.float64)
    full = torch.cdist(q.double(), xd)
    want = full.topk(TOPK, dim=1, largest=False).values
    got_rows = torch.gather(full, 1, ids)
    scale = float(want.abs().max())
    err = max(float((dist.double().sort(1).values - want).abs().max()),
              float((got_rows - dist.double()).abs().max()))
    ok = flagged >= 1 and launches["dist_blockmin"] >= 1 and err <= HOST_REL_TOL * scale
    emit({"phase": "covertree_fallback", "card": card, "shape": [n, d],
          "err_c": FALLBACK_ERR_C, "queries": HOST_QUERIES, "flagged": flagged,
          "launches": launches, "max_abs_dist_err": err, "tol": HOST_REL_TOL * scale,
          "ok": ok})
    if not ok:
        raise AssertionError(f"cover-tree fallback: flagged {flagged}, launches "
                             f"{launches}, err {err}")
    del algo, xd, full
    torch.cuda.empty_cache()
    return launches


# ---- 6. throughput -----------------------------------------------------


def _tf32x3_bounds(product_flops: float, flops: float, nbytes: float) -> dict:
    """The bounds of a 3xTF32 kernel (K1 f32, blockmin, assign): its route's, three
    TF32 products over the TF32 peak or the bytes over the bandwidth, and
    beside it the FP32 bound, all its operations over the FP32 peak."""
    route_ms = 3.0 * product_flops / TF32_PEAK_FLOPS * 1e3
    fp32_ms = flops / FP32_PEAK_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(route_ms, byte_ms),
            "bound_by": "operations" if route_ms >= byte_ms else "bytes",
            "fp32_bound_ms": max(fp32_ms, byte_ms)}



def phase_throughput(card: str, n: int, d: int, batches: int) -> dict:
    """Exact search's QPS at [n, d] through the flagship's own definition
    (``vectordb_retrieval_tpu_torch.flagship``: its draws, one untimed
    batch, the clock stopping with the ids on the host), then one batch's
    device time split into K1, ``_select_blocks`` and the rest."""
    import torch

    from vectordb_retrieval_tpu_torch import flagship
    from vectordb_retrieval_tpu_torch.ops import distances as dops
    from vectordb_retrieval_tpu_torch.ops import kernels

    dev = torch.device(DEV)
    db, sqn, qs = flagship.make_workload(n, d, batches, BATCH, SEED, dev)

    def search(qb):
        return dops.exact_search(qb, db, TOPK, metric="l2", db_sqnorms=sqn, device=dev)

    elapsed, ids_host = flagship.timed_stream(db, sqn, qs, TOPK)
    flagship.check_ids(ids_host, batches, BATCH, TOPK, n)

    # stage 1 alone at the main path's inputs
    w = dops.blockmin_width(n)
    s = kernels.dist_blockmin_pad_rows(n, w)
    if s != n:
        raise AssertionError(f"throughput shapes need n % w == 0 (n={n}, w={w})")
    q = qs[0].contiguous()
    pen = sqn.reshape(-1, w)
    kernel_ms = time_ms(lambda: kernels.dist_blockmin(q, db, pen, w=w))
    plain_ms = time_ms(lambda: kernels.dist_blockmin_reference(q, db, pen, w=w))
    library_ms = time_ms(lambda: torch.matmul(q, db.T))
    # where one batch's device time goes: stage 1, stage 2, the rest
    bmins = kernels.dist_blockmin(q, db, pen, w=w)
    nb = min(TOPK + dops._BLOCKMIN_SLACK, bmins.shape[1])
    select_ms = time_ms(lambda: dops._select_blocks(bmins, nb))
    batch_ms = time_ms(lambda: search(q))
    # products, pen add, min; each input read once, the minima written once
    flops, nbytes = kernels.dist_blockmin_work(BATCH, s, d, w, torch.float32)
    bounds = _tf32x3_bounds(2.0 * BATCH * s * d, flops, nbytes)
    out = {
        "phase": "throughput", "shape": [n, d], "metric": "l2", "topk": TOPK,
        "batch": BATCH, "batches": batches, "w": w, "card": card,
        "qps": batches * BATCH / elapsed, "seconds": elapsed,
        "ms_per_batch": elapsed / batches * 1e3,
        "dist_blockmin_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, **bounds, "flops": flops, "bytes": nbytes,
        "batch_device_ms": batch_ms, "select_blocks_ms": select_ms,
        "rescore_and_rest_ms": batch_ms - kernel_ms - select_ms,
    }
    emit(out)
    del db, qs
    torch.cuda.empty_cache()
    return out


def _qps(search, qs, bsz, k, n_vectors, name) -> tuple:
    """Seconds per pass over ``qs`` in batches of ``bsz`` (at least 8
    batches on the clock, which stops with the ids on the host)."""
    import torch

    batches = qs.shape[0] // bsz
    passes = max(1, -(-8 // batches))
    search(qs[:bsz], k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        ids = [search(qs[i * bsz : (i + 1) * bsz], k)[1] for i in range(batches)]
        torch.cuda.synchronize()
        ids_host = torch.cat(ids).cpu().numpy()
    elapsed = (time.perf_counter() - t0) / passes
    if ids_host.shape != (batches * bsz, k) or ids_host.max() >= n_vectors:
        raise AssertionError(f"{name}: ids malformed {ids_host.shape}")
    return elapsed, batches, passes


def phase_ivf_throughput(card: str, path_name: str, row: str, info, launches=None) -> dict:
    """One IVF row: QPS over its queries (the clock stops with the ids on
    the host; at least 8 batches on the clock), then one batch's device
    time by stage (an IVF-PQ row's decode first), and K1 beside its plain
    version, one library call and the card's bound. ``launches``: the main
    path's K1 launches at this row's shape."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import ivf
    from vectordb_retrieval_tpu_torch.ops import kernels

    st = _ivf_stages(info)
    searcher, k, bsz = st.searcher, st.k, info["batch"]
    qs = torch.as_tensor(info["queries"], device=DEV)
    elapsed, batches, passes = _qps(searcher.device_kernel, qs, bsz, k,
                                    info["algo"].artifact.metadata["n_vectors"],
                                    f"{path_name}/{row}")

    # the stages of one batch, each on the inputs the main path gives it,
    # timed on the device (primed: host launches are not what is measured)
    slack = ivf._BLOCKMIN_SLACK
    decode_ms = time_ms(st.decode, prime=True) if st.decode else 0.0
    coarse_ms = time_ms(st.coarse, prime=True)
    probes, valid = st.coarse()
    k1_ms = time_ms(lambda: kernels.dist_blockmin(st.qk, st.payload, st.pen, w=st.w),
                    prime=True)
    bm = kernels.dist_blockmin(st.qk, st.payload, st.pen, w=st.w)
    select_ms = time_ms(
        lambda: ivf._probed_blocks(bm, probes, st.n_bkt, st.bpb, k + slack, valid),
        prime=True)
    sel_vals, blk = ivf._probed_blocks(bm, probes, st.n_bkt, st.bpb, k + slack, valid)

    def rescore():
        return ivf._rescore_blocks(blk, sel_vals, st.scorer, k)

    rescore_ms = time_ms(rescore, prime=True)
    batch_ms = time_ms(lambda: searcher.device_kernel(st.q_raw, k), prime=True)
    # unprimed, the batch's events also see the host's launch rate
    batch_host_bound_ms = time_ms(lambda: searcher.device_kernel(st.q_raw, k))
    if not torch.equal(rescore()[1], searcher.device_kernel(st.q_raw, k)[1]):
        raise AssertionError(f"{path_name}/{row}: the stage split differs from the search")

    plain_ms = time_ms(lambda: kernels.dist_blockmin_reference(st.qk, st.payload, st.pen, w=st.w),
                       reps=5, warmup=1)
    qb = st.qk.to(torch.bfloat16)
    xb = st.payload.to(torch.bfloat16)  # u8 widened outside the clock
    library_ms = time_ms(lambda: torch.matmul(qb, xb.T), reps=10)
    del xb
    s_rows, dim = st.payload.shape
    flops = 2.0 * bsz * s_rows * dim
    nbytes = (2.0 * bsz * dim + st.payload.element_size() * s_rows * dim
              + 4.0 * s_rows + 4.0 * bsz * (s_rows // st.w))
    flop_ms = flops / BF16_PEAK_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    meta = info["algo"].artifact.metadata
    out = {
        "phase": "ivf_throughput", "config": path_name, "row": row,
        "index_key": meta["index_key"], "rotations": "list_rotations" in info["algo"].artifact.data,
        "kernel": _row_mode(info["algo"]), "card": card,
        "qps": batches * bsz / elapsed, "seconds": elapsed, "batches": batches,
        "passes": passes, "ms_per_batch": elapsed / batches * 1e3,
        "batch_device_ms": batch_ms, "batch_events_unprimed_ms": batch_host_bound_ms,
        "decode_ms": decode_ms, "coarse_probe_ms": coarse_ms, "dist_blockmin_ms": k1_ms,
        "probed_select_ms": select_ms, "rescore_ms": rescore_ms,
        "rest_ms": batch_ms - decode_ms - coarse_ms - k1_ms - select_ms - rescore_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "flops": flops, "bytes": nbytes, "launches": launches,
        "shape": [bsz, s_rows, dim, st.w], "probes_per_query": probes.shape[1],
    }
    emit(out)
    del bm, qs
    torch.cuda.empty_cache()
    return out


def _rows_within_radius(qw, words, ham) -> int:
    """Rows the threshold rerank scores: Hamming distance <= each query's
    radius, counted in the scan's chunks."""
    from vectordb_retrieval_tpu_torch.ops import lsh as lshops

    n = words.shape[0]
    c = lshops.chunk_rows(qw.shape[0] * qw.shape[1] * 8, n)
    return sum(int((lshops._hamming(qw, words[i : i + c]) <= ham[:, -1:]).sum())
               for i in range(0, n, c))


def phase_lsh_throughput(card: str, path_name: str, row: str, info) -> dict:
    """One LSH row: QPS, then one batch's device time by stage, each stage
    on the inputs the search gives it (events, 3 calls after 1). Binary
    LSH: query hashing, Hamming scan (the n-th smallest distance), and the
    dense threshold rerank or the gather rerank; multi-table LSH: hashing,
    votes, gather rerank, and exact search of the rows left short (the
    fallback, K1 f32 above exact search's dense-path limit) after the
    host read of their flags."""
    import torch

    from vectordb_retrieval_tpu_torch.models import lsh as lm
    from vectordb_retrieval_tpu_torch.ops import lsh as lshops

    algo = info["algo"]
    art, meta = algo.artifact, algo.artifact.metadata
    bsz, k = info["batch"], info["k"]
    qs = torch.as_tensor(info["queries"], device=DEV)
    name = f"{path_name}/{row}"
    elapsed, batches, passes = _qps(algo.device_kernel, qs, bsz, k, meta["n_vectors"], name)
    q = qs[:bsz]

    def tm(fn):
        return time_ms(fn, reps=3, warmup=1, prime=True)

    out = {"phase": "lsh_throughput", "config": path_name, "row": row, "kind": art.kind,
           "card": card, "qps": batches * bsz / elapsed, "seconds": elapsed,
           "batches": batches, "passes": passes, "ms_per_batch": elapsed / batches * 1e3,
           "shape": [bsz, meta["n_vectors"], meta["dimension"]], "k": k}
    if art.kind == "binary_lsh":
        d = art.data
        mult = float(algo.searcher.params.get("lsh_candidate_multiplier", 32.0))
        n_cand = lm.binary_n_candidates(art, k, mult)
        hash_ms = tm(lambda: lm.binary_words(q, d["projections"]))
        qw = lm.binary_words(q, d["projections"])
        scan_ms = tm(lambda: lshops.hamming_candidates(qw, d["words"], n_cand))
        ham, cand = lshops.hamming_candidates(qw, d["words"], n_cand)
        path = lm.binary_rerank_path(n_cand)
        if path == "threshold":
            def rerank():
                return lshops.hamming_threshold_rerank(q, qw, d["vectors"], d["words"],
                                                       ham[:, -1:], k)
        else:
            def rerank():
                return lshops.rerank(q, d["vectors"], cand, k)
        rerank_ms = tm(rerank)
        stages = {"hash_ms": hash_ms, "hamming_scan_ms": scan_ms, f"{path}_rerank_ms": rerank_ms}
        out.update({"num_bits": meta["num_bits"], "words": d["words"].shape[1],
                    "candidates": n_cand, "rerank_path": path,
                    "scan_chunk_rows": lshops.chunk_rows(bsz * d["words"].shape[1] * 8,
                                                         meta["n_vectors"]),
                    "rows_within_radius_per_query": _rows_within_radius(qw, d["words"], ham) / bsz})
        same = torch.equal(rerank()[1], algo.device_kernel(q, k)[1])
    else:
        s = algo.searcher
        eff_k = min(k, meta["n_vectors"])
        hash_ms = tm(lambda: s.hash_queries(q))
        qq, qk = s.hash_queries(q)
        vote_ms = tm(lambda: s.vote(qk, eff_k))
        cand = s.vote(qk, eff_k)
        rerank_ms = tm(lambda: s.rerank(qq, cand, eff_k))
        _, ids = s.rerank(qq, cand, eff_k)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            short = ((ids >= 0).sum(dim=1) < eff_k).nonzero()[:, 0]  # the batch's host read
        read_host_ms = (time.perf_counter() - t1) / 5 * 1e3
        fallback_ms = tm(lambda: s.fallback(qq[short], eff_k)) if short.numel() else 0.0
        stages = {"hash_ms": hash_ms, "votes_ms": vote_ms, "gather_rerank_ms": rerank_ms,
                  "fallback_exact_ms": fallback_ms}
        out.update({"num_tables": meta["num_tables"], "hash_size": meta["hash_size"],
                    "candidates": cand.shape[1], "fallback_rows": int(short.numel()),
                    "short_read_host_ms": read_host_ms})
        same = True
    batch_ms = time_ms(lambda: algo.device_kernel(q, k), reps=3, warmup=1, prime=True)
    out.update(stages)
    out.update({"batch_device_ms": batch_ms, "rest_ms": batch_ms - sum(stages.values()),
                "stages_equal_search": same})
    emit(out)
    if not same:
        raise AssertionError(f"{name}: the stage split differs from the search")
    del qs
    torch.cuda.empty_cache()
    return out


# K2's device work by launch, matched by name in the profiler's trace
K2_LAUNCHES = ("Memset", "slab_prep_kernel", "slab_scan_kernel", "slab_scatter_kernel",
               "slab_dots_tc_kernel")


def _k2_launch_split(fn, reps: int = 10):
    """Device ms a call of each of K2's launches (the counts' memset, the
    grouping's three kernels, the product), from torch.profiler's
    key_averages over ``reps`` calls; None where the trace holds no device
    time, the error's text where tracing failed (a report, not a gate)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except Exception as e:  # the card's tracing is untried: report, go on
        return repr(e)
    split = dict.fromkeys(K2_LAUNCHES, 0.0)
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        for name in K2_LAUNCHES:
            if name in ev.key:
                split[name] += us / reps / 1e3
    return split if any(split.values()) else None


def _slab_dots_numbers(q, lv, sel) -> dict:
    """slab_dots on one wave's own inputs: one launch under
    torch.cuda.set_sync_debug_mode("error") (its grouping must not wait for
    the device), the grouping's spread, the kernel, its plain version, the
    library product and the gather it needs, and the card's bound."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    b, w = sel.shape
    nb, length, d = lv.shape
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernels.slab_dots(q, lv, sel)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms = time_ms(lambda: kernels.slab_dots(q, lv, sel), prime=True)
    split_ms = _k2_launch_split(lambda: kernels.slab_dots(q, lv, sel))
    plain_ms = time_ms(lambda: kernels.slab_dots_reference(q, lv, sel), reps=3, warmup=1)
    idx = sel.long()
    # the library yardstick: one FP32 batched product of the gathered slabs
    # (widened to f32 outside the clock) with the queries; the gather timed
    # on its own
    gather_ms = time_ms(lambda: lv[idx].float(), reps=5, warmup=1)
    gathered = lv[idx].float().reshape(b, w * length, d)
    library_ms = time_ms(lambda: torch.bmm(gathered, q[:, :, None]), reps=5, warmup=1)
    del gathered
    torch.cuda.empty_cache()
    groups = slab_groups(sel, nb)
    esize = lv.element_size()
    flops = 2.0 * b * w * length * d
    nbytes = (groups["distinct_blocks"] * length * d * esize + 4.0 * b * d + 4.0 * b * w
              + 4.0 * b * w * length)
    # three products a pair on the tensor cores: bf16 pieces (bf16 slabs),
    # 3xTF32 (f32 slabs)
    peak = BF16_PEAK_FLOPS if lv.dtype == torch.bfloat16 else TF32_PEAK_FLOPS
    flop_ms = 3.0 * flops / peak * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pair_bytes = float(b * w * length * d * esize)
    return {
        "slab_dots_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "gather_ms": gather_ms, "bound_ms": max(flop_ms, byte_ms),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "flops": flops, "bytes": nbytes, **groups, "sync_free": True, "launch_split_ms": split_ms,
        "per_pair_bytes": pair_bytes,
        "per_pair_bytes_ms": pair_bytes / HBM_BYTES_PER_S * 1e3,
        "shape": [b, w, length, d],
    }


def phase_graph_throughput(card: str, path_name: str, row: str, info) -> dict:
    """One graph row: QPS over its queries (the clock stops with the ids on
    the host), then one batch's device time by stage, each stage timed on
    the inputs the search gives it (primed events), and slab_dots on every
    wave's own inputs beside its plain version, the library product and the
    card's bound."""
    import torch

    from vectordb_retrieval_tpu_torch.models import graph as gm
    from vectordb_retrieval_tpu_torch.ops import distances as dops
    from vectordb_retrieval_tpu_torch.ops import graph as gops

    algo = info["algo"]
    searcher, art = algo.searcher, algo.artifact
    meta, data = art.metadata, art.data
    bsz, k = info["batch"], min(info["k"], meta["n_vectors"])
    qs = torch.as_tensor(info["queries"], device=DEV)
    elapsed, batches, passes = _qps(searcher.device_kernel, qs, bsz, k, meta["n_vectors"],
                                    f"{path_name}/{row}")

    q_raw = qs[:bsz]
    q = dops.normalize(q_raw) if meta.get("normalize_queries") else q_raw
    metric = searcher._score_metric()
    ef = int(searcher.params.get("efSearch", meta.get("efSearch", 100)))
    out = {"phase": "graph_throughput", "config": path_name, "row": row,
           "mode": meta.get("mode", "node"), "card": card,
           "qps": batches * bsz / elapsed, "seconds": elapsed, "batches": batches,
           "passes": passes, "batch": bsz, "ms_per_batch": elapsed / batches * 1e3}
    stage_sum = 0.0
    if meta.get("mode") == "block":
        efb, expand, iters = gm.block_geometry(
            int(meta["n_blocks"]), ef, k, block_len=int(meta["block_len"]))
        beam = gops.BlockBeam(
            q, data["entries"], data["entry_block"], data["slot_ids"],
            data["list_vecs"], data["list_sqnorms"], data["entry_adj"],
            data.get("list_mu"), k=k, efb=efb, expand=expand, iters=iters,
            metric=metric, dedup=float(meta.get("spill", 0.0)) > 0.0)
        seed_ms = time_ms(beam.seed, prime=True)
        stage_sum += seed_ms
        st = beam.seed()
        waves = []
        for t in range(iters):
            pop_ms = time_ms(lambda: beam.pop(st, t), prime=True)
            st, p = beam.pop(st, t)
            k2 = _slab_dots_numbers(q, data["list_vecs"], p.safe_blk)
            dots = beam.score(p)
            merge_ms = time_ms(lambda: beam.merge(st, p, dots), prime=True)
            st = beam.merge(st, p, dots)
            push_ms = 0.0
            if t < iters - 1:
                push_ms = time_ms(lambda: beam.push(st, p), prime=True)
                st = beam.push(st, p)
            stage_sum += pop_ms + k2["slab_dots_ms"] + merge_ms + push_ms
            waves.append(dict(k2, wave=t, pop_ms=pop_ms, merge_ms=merge_ms,
                              push_ms=push_ms))
        result_ms = time_ms(lambda: beam.result(st), prime=True)
        stage_sum += result_ms
        stage_ids = beam.result(st)[1]
        out.update({"efb": efb, "expand": expand, "iters": iters,
                    "seed_ms": seed_ms, "waves": waves, "result_ms": result_ms})
    else:
        n = int(meta["n_vectors"])
        degree = int(meta.get("degree", data["adjacency"].shape[1]))
        ef_n, expand, keep, iters = gm.beam_geometry(n, degree, ef, k)
        nbr_vecs = data.get("nbr_vecs")
        beam = gops.NodeBeam(
            q, data["vectors"], data["adjacency"], data["entry_ids"], k, ef=ef_n,
            expand=expand, iters=iters, metric=metric, sqnorms=data.get("sqnorms"),
            cand_keep=keep, nbr_vecs=nbr_vecs, nbr_sqn=data.get("nbr_sqn"),
            rescore=nbr_vecs is not None, nbr_vmin=data.get("nbr_vmin"),
            nbr_step=data.get("nbr_step"))
        seed_ms = time_ms(beam.seed, prime=True)
        st = beam.seed()
        step_ms = []
        for _ in range(iters):
            step_ms.append(time_ms(lambda: beam.step(st), prime=True))
            st = beam.step(st)
        result_ms = time_ms(lambda: beam.result(st), prime=True)
        stage_sum = seed_ms + sum(step_ms) + result_ms
        stage_ids = beam.result(st)[1]
        out.update({"ef": ef_n, "expand": expand, "keep": keep, "iters": iters,
                    "degree": degree, "seed_ms": seed_ms, "step_ms": step_ms,
                    "result_ms": result_ms})
    batch_ms = time_ms(lambda: searcher.device_kernel(q_raw, k), prime=True)
    batch_unprimed_ms = time_ms(lambda: searcher.device_kernel(q_raw, k))
    if not torch.equal(stage_ids, searcher.device_kernel(q_raw, k)[1]):
        raise AssertionError(f"{path_name}/{row}: the stage split differs from the search")
    out.update({"batch_device_ms": batch_ms, "batch_events_unprimed_ms": batch_unprimed_ms,
                "rest_ms": batch_ms - stage_sum})
    emit(out)
    del qs
    torch.cuda.empty_cache()
    return out


def phase_covertree_throughput(card: str, path_name: str, info) -> dict:
    """The cover tree's row: QPS over its queries (the clock stops with the
    ids on the host), then one batch's device time by stage, each stage
    timed on the inputs the search gives it (primed events): the K1 pair
    launch, the descent, the selection, the gather, rescore and
    certificate, and the exact search of the flagged rows; the host read of
    the flags on the host clock; and K1 bf16 at this shape (one pen) and the
    pair, each beside its plain version, one library call and the card's
    bound. Returns the K1 numbers by kernel name."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import covertree as ctops
    from vectordb_retrieval_tpu_torch.ops import kernels

    algo = info["algo"]
    meta, data = algo.artifact.metadata, algo.artifact.data
    bsz, k = info["batch"], info["k"]
    qs = torch.as_tensor(info["queries"], device=DEV)
    elapsed, batches, passes = _qps(algo.device_kernel, qs, bsz, k, meta["n_vectors"], path_name)

    q_raw = qs[:bsz]
    q = _ct_queries(algo, q_raw)
    prep = algo.blockwalk_prep()
    kp = algo._kprime(k, meta["n_vectors"])
    k1_ms = time_ms(lambda: ctops.blockwalk_stage1(q, prep), prime=True)
    bm_all, bm_real = ctops.blockwalk_stage1(q, prep)
    descent_ms = time_ms(
        lambda: ctops.blockwalk_descent(q, bm_all, bm_real, prep, k, kp, algo.err_c), prime=True)
    cand, _ = ctops.blockwalk_descent(q, bm_all, bm_real, prep, k, kp, algo.err_c)
    select_ms = time_ms(lambda: ctops.blockwalk_select(cand, k), prime=True)
    bm_sel, blk = ctops.blockwalk_select(cand, k)
    qn = torch.sqrt(torch.sum(q * q, dim=-1))

    def rescore():
        out_d, out_i = ctops.rescore_blocks(q, data["slab"], data["is_real"],
                                            data["point_ids"], blk, prep.w, k)
        return out_d, out_i, ctops.certify(out_d, bm_sel[:, -1], qn, prep.max_xn, algo.err_c, k)

    rescore_ms = time_ms(rescore, prime=True)
    _, stage_ids, overflow = rescore()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(20):
        flagged = overflow.nonzero()[:, 0]  # the batch's one host read
    read_host_ms = (time.perf_counter() - t1) / 20 * 1e3
    fallback_ms = time_ms(lambda: algo._exact(q[flagged], k), prime=True) if flagged.numel() else 0.0
    search_ms = time_ms(lambda: algo._search(q, k), prime=True)
    batch_events_ms = time_ms(lambda: algo.device_kernel(q_raw, k))
    kept = ~overflow
    if not torch.equal(stage_ids.long()[kept], algo.device_kernel(q_raw, k)[1][kept]):
        raise AssertionError(f"{path_name}: the stage split differs from the search")
    stages_ms = k1_ms + descent_ms + select_ms + rescore_ms
    out = {
        "phase": "covertree_throughput", "config": path_name, "card": card,
        "qps": batches * bsz / elapsed, "seconds": elapsed, "batches": batches,
        "passes": passes, "batch": bsz, "ms_per_batch": elapsed / batches * 1e3,
        "depths": len(prep.depth_sizes), "w": prep.w, "blocks": prep.pen_all.shape[0],
        "k1_pair_ms": k1_ms, "descent_ms": descent_ms, "select_ms": select_ms,
        "rescore_certify_ms": rescore_ms, "overflow_read_host_ms": read_host_ms,
        "flagged_queries": int(flagged.numel()), "fallback_exact_ms": fallback_ms,
        "stages_device_ms": stages_ms, "search_device_ms": search_ms,
        "batch_events_ms": batch_events_ms,
    }
    emit(out)

    # K1 bf16 at this shape: one launch with one pen (pen_all), and the
    # pair (pen_all, pen_real) that the block walk launches; one library
    # product (bf16, the same for both) as the yardstick
    slab_bf, w = prep.slab_bf, prep.w
    m, dim = slab_bf.shape
    qb = q.to(torch.bfloat16)
    library_ms = time_ms(lambda: torch.matmul(qb, slab_bf.T), reps=10)
    flops = 2.0 * bsz * m * dim
    k1 = {}
    for name, pens in (("dist_blockmin_bf16", (prep.pen_all,)),
                       (PAIR, (prep.pen_all, prep.pen_real))):
        if len(pens) == 1:
            ms = time_ms(lambda: kernels.dist_blockmin(q, slab_bf, pens[0], w=w))
            plain_ms = time_ms(lambda: kernels.dist_blockmin_reference(q, slab_bf, pens[0], w=w),
                               reps=3, warmup=1)
        else:
            ms = time_ms(lambda: kernels.dist_blockmin_pair(q, slab_bf, *pens, w=w))
            plain_ms = time_ms(lambda: kernels.dist_blockmin_pair_reference(q, slab_bf, *pens, w=w),
                               reps=3, warmup=1)
        nbytes = 2.0 * bsz * dim + 2.0 * m * dim + len(pens) * (4.0 * m + 4.0 * bsz * (m // w))
        flop_ms = flops / BF16_PEAK_FLOPS * 1e3
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        k1[name] = {"phase": "covertree_k1", "kernel": name, "config": path_name, "card": card,
                    "shape": [bsz, m, dim, w], "pens": len(pens), "dist_blockmin_ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": max(flop_ms, byte_ms),
                    "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
                    "flops": flops, "bytes": nbytes}
        emit(k1[name])
    del qs, bm_all, bm_real, cand
    torch.cuda.empty_cache()
    return k1


def phase_blockmin_throughput(card: str) -> dict:
    """K4 at exact search's flagship shape (256 x 100,352 x 384, w = 8, the
    last 352 rows of 1e6): kernel, plain version, one FP32 library product
    (TF32 off) and the card's bound."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    b, n, d, w, pad = K4_SHAPES[-1]
    q, x = _k4_inputs(b, n, d, pad, SEED)
    ms = time_ms(lambda: kernels.blockmin(q, x, w=w))
    plain_ms = time_ms(lambda: kernels.blockmin_reference(q, x, w=w), reps=5, warmup=1)
    library_ms = time_ms(lambda: torch.matmul(q, x.T), reps=10)
    flops = 2.0 * b * n * d
    nbytes = 4.0 * (b * d + n * d + b * (n // w))
    out = {
        "phase": "blockmin_throughput", "shape": [b, n, d, w], "card": card,
        "blockmin_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **_tf32x3_bounds(flops, flops, nbytes), "flops": flops, "bytes": nbytes,
    }
    emit(out)
    del q, x
    torch.cuda.empty_cache()
    return out


def phase_matmul_floor_throughput(card: str) -> list:
    """K5 at phase 7d's two shapes (exp_dbm_tune at its defaults and at 1M
    x 128, w = 32): kernel, plain version (FP32, TF32 off), one library
    call computing the same function (the strided product ``x[::w] @
    q.T``) and the function's bound (its ``S/w`` rows only), and K1 f32 on
    the same inputs beside it: K1's time less K5's is what K1 loses to the
    card's product loop, epilogue included. The kernel multiplies every
    row, as K1's main loop does, so the bound of that loop stands apart as
    ``k1_loop_bound_ms`` (three TF32 products of every row, or the queries
    and the whole payload read once); ``k1_loop_bound_share`` and
    ``bound_share`` are each bound over the kernel's time, ``earlier_ms``
    PR 17's K5 at the shape (not measured here)."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    out = []
    for b, s, d, w, _ in K5_SHAPES[:2]:
        g = torch.Generator(device=DEV).manual_seed(SEED)
        q = torch.randn((b, d), generator=g, device=DEV)
        x = torch.randn((s, d), generator=g, device=DEV)
        pen = torch.sum(x * x, dim=1).reshape(-1, w)
        ms = time_ms(lambda: kernels.matmul_floor(q, x, w=w), prime=True)
        k1_ms = time_ms(lambda: kernels.dist_blockmin(q, x, pen, w=w), prime=True)
        plain_ms = time_ms(lambda: kernels.matmul_floor_reference(q, x, w), reps=10)
        library_ms = time_ms(lambda: torch.matmul(x[::w], q.T), reps=10)
        flops, nbytes = kernels.matmul_floor_work(b, s, d, w)
        loop = _tf32x3_bounds(2.0 * b * s * d, 2.0 * b * s * d, 4.0 * (b * d + s * d))
        bounds = _tf32x3_bounds(flops, flops, nbytes)
        line = {"phase": "matmul_floor_throughput", "shape": [b, s, d, w], "card": card,
                "matmul_floor_ms": ms, "dist_blockmin_ms": k1_ms, "k1_less_k5_ms": k1_ms - ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                **bounds, "flops": flops, "bytes": nbytes, "bound_share": bounds["bound_ms"] / ms,
                "k1_loop_bound_ms": loop["bound_ms"], "k1_loop_bound_by": loop["bound_by"],
                "k1_loop_bound_share": loop["bound_ms"] / ms,
                "earlier_ms": K5_EARLIER_MS[(b, s, d, w)]}
        emit(line)
        out.append(line)
        del q, x, pen
        torch.cuda.empty_cache()
    return out


def _k6_cell_data(cell: dict) -> tuple:
    """The corpus and the first batch of queries of one K6_CELLS entry from
    the port's own surrogates (the recipes and data seeds the benchmark's
    configurations name): the SIFT1M surrogate phase 1 wrote, or the
    msmarco_surrogate loader at its shipped knobs."""
    from vectordb_retrieval_tpu_torch.data import datasets

    if cell["data"] == "sift1m_surrogate":
        base = datasets.read_fvecs(os.path.join(SIFT_DIR, "sift_base.fvecs"))
        queries = datasets.read_fvecs(os.path.join(SIFT_DIR, "sift_query.fvecs"), cell["batch"])
        return base, queries
    ds = datasets.Dataset(cell["data"], data_dir=OUT_DIR, options={
        "train_limit": cell["n"], "test_size": cell["batch"], "ground_truth_k": cell["k"],
        "metric": cell["metric"], "use_cache": False}, device=DEV).load()
    return ds.train_vectors, ds.test_vectors


def phase_glove50_graph(card: str) -> dict:
    """K2 at the benchmark cell glove50.hnsw's shape, on the port's own
    data and index: the glove50_surrogate loader at GLOVE50's rows, the
    block graph built as the cell builds it, then phase_graph_throughput
    (QPS; each stage timed on the inputs the search gives it; K2 on every
    wave's own inputs beside its plain version, checked against it). Each
    wave's line adds the share of its pairs' slabs that are distinct and
    the bound from ``kernels.slab_dots_work`` (three bf16 products a pair;
    the distinct slabs, queries and ids read once, the dots written);
    recall@10 against the loader's ground truth."""
    import torch

    from vectordb_retrieval_tpu_torch.bench.metrics import recall_at_k
    from vectordb_retrieval_tpu_torch.data import datasets
    from vectordb_retrieval_tpu_torch.models import get_algorithm_instance
    from vectordb_retrieval_tpu_torch.models import graph as gm
    from vectordb_retrieval_tpu_torch.ops import kernels

    ds = datasets.Dataset("glove50_surrogate", data_dir=OUT_DIR, options={
        "train_limit": GLOVE50["rows"], "test_size": GLOVE50["queries"],
        "ground_truth_k": GLOVE50["k"], "metric": "cosine", "use_cache": False},
        device=DEV).load()
    ef = GLOVE50["efSearch"]
    algo = get_algorithm_instance(
        "composite", dimension=50, device=DEV, metric="cosine",
        indexer={"type": "GraphIndexer", "metric": "cosine", "M": 16, "efConstruction": 200,
                 "efSearch": ef, "mode": "block"},
        searcher={"type": "ANNSearcher", "metric": "cosine", "efSearch": ef})
    t0 = time.perf_counter()
    algo.build_index(ds.train_vectors)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _, ids = algo.batch_search(ds.test_vectors, GLOVE50["k"])
    recall = float(recall_at_k(np.asarray(ds.ground_truth)[:, :GLOVE50["k"]], ids, GLOVE50["k"]))
    info = {"algo": algo, "batch": GLOVE50["queries"], "k": GLOVE50["k"],
            "queries": ds.test_vectors}
    out = phase_graph_throughput(card, "glove50_surrogate", "hnsw_block", info)
    meta = algo.artifact.metadata
    for wave in out["waves"]:
        b, w, length, d = wave["shape"]
        flops, nbytes = kernels.slab_dots_work(b, w, length, d, 2, 8, wave["distinct_blocks"])
        bound_ms = max(3.0 * flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        line = {"phase": "k2_glove50", "card": card, "wave": wave["wave"],
                "shape": wave["shape"], "n_blocks": meta["n_blocks"],
                "slab_dots_ms": wave["slab_dots_ms"], "plain_ms": wave["plain_ms"],
                "library_ms": wave["library_ms"], "distinct_blocks": wave["distinct_blocks"],
                "distinct_share": wave["distinct_blocks"] / (b * w),
                "work_bound_ms": bound_ms, "bound_share": bound_ms / wave["slab_dots_ms"],
                "launch_split_ms": wave["launch_split_ms"]}
        emit(line)
        wave.update(line)
    out.update({"build_s": build_s, "recall_at_10": recall,
                "selfcheck_recall": meta.get("selfcheck_recall"),
                "n_blocks": meta["n_blocks"], "n_entries": meta["n_entries"]})
    emit({"phase": "glove50_graph", "card": card, "build_s": build_s, "recall_at_10": recall,
          "selfcheck_recall": meta.get("selfcheck_recall"), "qps": out["qps"],
          "ms_per_batch": out["ms_per_batch"], "n_blocks": meta["n_blocks"],
          "n_entries": meta["n_entries"]})
    if recall < gm._SELFCHECK_MIN:  # the recall a block build must reach in auto mode
        raise AssertionError(f"glove50 block graph: recall@10 {recall}")
    del algo, ds
    torch.cuda.empty_cache()
    return out


def phase_block_rescore_throughput(card: str) -> list:
    """K6 at the benchmark's two exact cells' shapes (K6_CELLS) on the
    port's surrogates of their data (``_k6_cell_data``; cosine rows
    normalised as the port's exact index does), the blocks chosen by exact
    search's stages 1 and 2 (``distances._blockmin_blocks`` at the cell's
    k and the width rule's w). Kernel, plain version on the card, the
    function's bound (``block_rescore_work``: the distinct selected blocks
    read once), the share of the pairs' blocks that are distinct, the bound
    were every pair's block read (``pairs_bound_ms``), both shares of the
    kernel's time, and the max difference from the plain version."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import distances, kernels

    out = []
    for cell in K6_CELLS:
        base, queries = _k6_cell_data(cell)
        x = torch.as_tensor(base, device=DEV)
        q = torch.as_tensor(queries, device=DEV)
        if cell["metric"] == "cosine":
            x, q = distances.normalize(x), distances.normalize(q)
        (n, d), b, k = x.shape, q.shape[0], cell["k"]
        if (n, d, b) != (cell["n"], cell["d"], cell["batch"]):
            raise AssertionError(f"{cell['cell']}: data {n} x {d}, {b} queries")
        w = distances.blockmin_width(n)
        metric = "l2" if cell["metric"] == "l2" else "ip"
        payload, blk = distances._blockmin_blocks(q, x, None, k, cell["metric"],
                                                  distances.DEFAULT_CHUNK_ROWS, w)
        nb = blk.shape[1]
        err = check_block_rescore(q, payload, blk, n, w, metric, cell["cell"],
                                  exact=cell["data"] == "sift1m_surrogate")
        ms = time_ms(lambda: kernels.block_rescore(q, payload, blk, n, w, metric), prime=True)
        plain_ms = time_ms(
            lambda: kernels.block_rescore_reference(q, payload, blk, n, w, metric),
            reps=10, prime=True)
        distinct = int(torch.unique(blk).numel())
        flops, nbytes = kernels.block_rescore_work(b, nb, w, d, distinct, metric)
        _, pair_bytes = kernels.block_rescore_work(b, nb, w, d, b * nb, metric)
        bound_ms = max(flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        pairs_bound_ms = pair_bytes / HBM_BYTES_PER_S * 1e3
        line = {"phase": "block_rescore_throughput", "cell": cell["cell"], "card": card,
                "data": cell["data"], "shape": [b, n, d, w, nb], "metric": metric,
                "block_rescore_ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_PEAK_FLOPS
                else "operations",
                "bound_share": bound_ms / ms, "distinct_blocks": distinct,
                "distinct_share": distinct / (b * nb), "pairs_bound_ms": pairs_bound_ms,
                "pairs_bound_share": pairs_bound_ms / ms, "flops": flops, "bytes": nbytes,
                "max_abs_err": err}
        emit(line)
        out.append(line)
        del x, q, payload, blk
        torch.cuda.empty_cache()
    return out


def phase_ivf_rescore_throughput(card: str, path_name: str, info) -> dict:
    """The IVF bf16 rescore at an IVF-Flat row's shape (the SIFT surrogate's
    ``IVF1024,Flat`` np 32, B 256, k 100: sift1m.ivf_flat's), on the blocks
    its stages 1 and 2 select for the row's first batch: checked against
    its plain version (the gathered chain the kernel replaced) there and on
    the same inputs with the payload one element into its buffer (single
    loads); the kernel, the plain version, the function's bound
    (``ivf_block_rescore_work``: the probed pairs' distinct blocks read
    once), the bound were every pair's block read and both shares of the
    kernel's time."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import ivf, kernels

    st = _ivf_stages(info)
    probes, valid = st.coarse()
    bm = kernels.dist_blockmin(st.qk, st.payload, st.pen, w=st.w)
    vals, blk = ivf._probed_blocks(bm, probes, st.n_bkt, st.bpb, st.k + ivf._BLOCKMIN_SLACK,
                                   valid)
    before = kernels.LAUNCHES["ivf_block_rescore"]
    st.scorer(blk, vals)
    if kernels.LAUNCHES["ivf_block_rescore"] != before + 1:
        raise AssertionError(f"{path_name}: the row's stage 3 is not the IVF bf16 rescore")
    q, w, metric = st.coding.queries.float().contiguous(), st.w, st.metric
    x = st.coding.rows.reshape(-1, st.coding.rows.shape[-1])
    slots = st.slot_ids.reshape(-1)
    integer = bool(torch.equal(q, q.round()) and torch.equal(x.float(), x.float().round()))
    err = check_ivf_block_rescore(q, x, slots, blk, vals, w, metric, path_name, exact=integer)
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=DEV)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    err = max(err, check_ivf_block_rescore(q, view, slots, blk, vals, w, metric,
                                           f"{path_name}/view+1", exact=integer))
    del buf, view
    ms = time_ms(lambda: kernels.ivf_block_rescore(q, x, slots, blk, vals, w, metric),
                 prime=True)
    plain_ms = time_ms(
        lambda: kernels.ivf_block_rescore_reference(q, x, slots, blk, vals, w, metric),
        reps=10, prime=True)
    (b, nb), d = blk.shape, x.shape[1]
    probed = torch.isfinite(vals)
    distinct = int(torch.unique(blk[probed]).numel())
    pairs = int(probed.sum())
    flops, nbytes = kernels.ivf_block_rescore_work(b, nb, w, d, pairs, distinct, metric)
    _, pair_bytes = kernels.ivf_block_rescore_work(b, nb, w, d, pairs, pairs, metric)
    bound_ms = max(flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    pairs_bound_ms = pair_bytes / HBM_BYTES_PER_S * 1e3
    out = {"phase": "ivf_rescore_throughput", "config": path_name, "row": "ivf_flat",
           "card": card, "shape": [b, x.shape[0], d, w, nb], "metric": metric,
           "ivf_block_rescore_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_PEAK_FLOPS
           else "operations",
           "bound_share": bound_ms / ms, "probed_pairs": pairs, "distinct_blocks": distinct,
           "distinct_share": distinct / pairs, "pairs_bound_ms": pairs_bound_ms,
           "pairs_bound_share": pairs_bound_ms / ms, "flops": flops, "bytes": nbytes,
           "integer_rows": integer, "max_abs_err": err}
    emit(out)
    del bm, vals, blk
    torch.cuda.empty_cache()
    return out


def phase_assign_throughput(card: str, n=1_000_000, k=1024, d=128) -> dict:
    """The IVF1024 corpus assignment at the SIFT1M shape: kernel, plain
    version, one FP32 library product (TF32 off) and the card's bounds (the
    3xTF32 route's, the FP32 bound beside it); then one Lloyd iteration of
    ops/kmeans.py at this shape (assign, then the one-hot centroid update)
    beside the assignment alone."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels
    from vectordb_retrieval_tpu_torch.ops import kmeans

    g = torch.Generator(device=DEV).manual_seed(SEED)
    p = torch.randn((n, d), generator=g, device=DEV)
    c = torch.randn((k, d), generator=g, device=DEV)
    ms = time_ms(lambda: kernels.assign(p, c), reps=10)
    plain_ms = time_ms(lambda: kernels.assign_reference(p, c), reps=5, warmup=1)
    library_ms = time_ms(lambda: torch.matmul(p, c.T), reps=10)
    lloyd_ms = time_ms(lambda: kmeans._lloyd(p, c, iters=1), reps=5, warmup=1)
    flops = 2.0 * n * k * d
    nbytes = 4.0 * (n * d + k * d + k) + 8.0 * n + 4.0 * n
    out = {
        "phase": "assign_throughput", "shape": [n, k, d], "card": card,
        "assign_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **_tf32x3_bounds(flops, flops, nbytes), "flops": flops, "bytes": nbytes,
        "lloyd_iteration_ms": lloyd_ms, "lloyd_update_ms": lloyd_ms - ms,
    }
    emit(out)
    del p
    torch.cuda.empty_cache()
    return out


def phase_assign_dsub_throughput(card: str, launches: dict, n: int = 65_536) -> list:
    """K3 at PQ training's shapes, [65,536 points, 256 codes, dsub]: the
    kernel, its plain version, one FP32 library product (TF32 off) and the
    card's bounds, beside the main path's launches at each dsub."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    out = []
    for dsub in K3_DSUB:
        g = torch.Generator(device=DEV).manual_seed(SEED + dsub)
        p = torch.randn((n, dsub), generator=g, device=DEV)
        c = torch.randn((KSUB, dsub), generator=g, device=DEV)
        ms = time_ms(lambda: kernels.assign(p, c))
        plain_ms = time_ms(lambda: kernels.assign_reference(p, c))
        library_ms = time_ms(lambda: torch.matmul(p, c.T))
        flops = 2.0 * n * KSUB * dsub
        nbytes = 4.0 * (n * dsub + KSUB * dsub + KSUB) + 8.0 * n + 4.0 * n
        line = {
            "phase": "assign_dsub_throughput", "shape": [n, KSUB, dsub], "card": card,
            "assign_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **_tf32x3_bounds(flops, flops, nbytes), "flops": flops, "bytes": nbytes,
            "launches": launches.get(dsub, 0),
        }
        emit(line)
        out.append(line)
    torch.cuda.empty_cache()
    return out


# ---- 5e. serving (mutable flat and IVF indexes) ---------------------------

# Each mutable flat index starts at the default capacity and fills by adds:
# the MS MARCO MiniLM shape (random 100k x 384, cosine; capacity 131,072,
# the scan's dense branch) and the SIFT1M surrogate (1M x 128, l2, 16
# batches of 62,500; capacity 1,048,576, 8 streamed chunks).
SERVING_FLAT_SHAPES = (
    {"name": "msmarco_shape", "n": 100_000, "d": 384, "metric": "cosine", "batches": 10},
    {"name": "sift1m_surrogate", "n": SIFT_ROWS, "d": 128, "metric": "l2", "batches": 16},
)
SERVING_KS = (20, 100)
SERVING_DELETE = 0.30  # share of ids deleted (the flat indexes compact)
SERVING_FILTER = 0.10  # share of live ids in the wide allow-list
SERVING_FILTER_IDS = 1000  # the narrow allow-list
SERVING_READD = 100_000
# MutableIVFIndex over a seeded random half of the SIFT surrogate, the
# other half added in 10 batches (bucket growth), 20 % of ids deleted.
SERVING_IVF = {"nlist": 1024, "nprobe": 32, "add_batches": 10, "delete": 0.20}
# configs/sift1m.yaml's committed IVF1024,Flat np32 recall@100 less the
# margin: the serving probe budget is a superset of the immutable row's
SERVING_IVF_MIN_RECALL = SIFT_COMMITTED["ivf_flat"] - RECALL_MARGIN


def _timed_compact(idx, seconds: list) -> None:
    """Record the seconds of every compaction of ``idx`` (also the ones a
    delete or a snapshot triggers)."""
    from vectordb_retrieval_tpu_torch.utils.device import synchronize

    inner = idx.compact

    def compact():
        t = time.perf_counter()
        inner()
        synchronize(idx.device)
        seconds.append(time.perf_counter() - t)

    idx.compact = compact


def _exact_distances(rows, q, metric):
    """float64 distances ``[B, M]`` of ``rows [M, d]`` to ``q [B, d]`` in the
    index's convention (l2: squared, cosine: negated cosine)."""
    r, qq = rows.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        r = r / np.maximum(np.linalg.norm(r, axis=1, keepdims=True), 1e-12)
        qq = qq / np.maximum(np.linalg.norm(qq, axis=1, keepdims=True), 1e-12)
        return -(qq @ r.T)
    return ((qq[:, None, :] - r[None, :, :]) ** 2).sum(-1)


def _id_classes(vec_of, q, ids, metric):
    """Each stable id as its float64 distance to its query: rows at one
    distance form a class (the SIFT surrogate's integer rows tie exactly;
    random float rows never do), -1 stays -1."""
    out = np.full(ids.shape, -1.0)
    for i in range(ids.shape[0]):
        ok = ids[i] >= 0
        if ok.any():
            out[i, ok] = _exact_distances(vec_of(ids[i, ok]), q[i : i + 1], metric)[0]
    return out


def _exact_live(vec_of, live, q, k, metric):
    """Stable ids of the exact top-k over ``live`` on the card (the port's
    exact search, refine), and their distances."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import distances as dops

    rows = torch.as_tensor(vec_of(live), device=DEV)
    qd = torch.as_tensor(q, device=DEV)
    score = metric
    if metric == "cosine":
        rows, qd, score = dops.normalize(rows), dops.normalize(qd), "ip"
    d, pos = dops.exact_search(qd, rows, min(k, len(live)), metric=score, refine=True)
    del rows
    return live[pos.cpu().numpy()], d.cpu().numpy()


def _hold_to_exact(name, vec_of, q, searches, metric, min_agree):
    """Every search of a serving sequence against the exact top-k over its
    allowed live rows: ids modulo distance classes, every id allowed and
    live, distances to the float64 tolerance. Returns a line per search."""
    out = {}
    for label, (k, live, (dists, ids)) in searches.items():
        want, _ = _exact_live(vec_of, live, q, k, metric)
        agree, same = _multiset_agreement(*(_id_classes(vec_of, q, x, metric) for x in (ids, want)),
                                          k)
        raw, _ = _multiset_agreement(ids, want, k)
        inside = bool(np.isin(ids[ids >= 0], live).all())
        got_d = np.sort(dists, 1)[:, : want.shape[1]]
        want_d = np.sort(np.stack([_exact_distances(vec_of(w), q[i : i + 1], metric)[0]
                                   for i, w in enumerate(want)]), 1)
        err = float(np.abs(got_d - want_d).max())
        tol = GT_REL_TOL * float(np.abs(want_d).max())
        ok = agree >= min_agree and inside and err <= tol
        out[label] = {"k": k, "allowed_live": int(len(live)), "id_agreement": agree,
                      "raw_id_agreement": raw, "queries_equal_modulo_classes": int(np.sum(same)),
                      "ids_allowed_and_live": inside, "max_abs_dist_err": err, "tol": tol,
                      "ok": ok}
        if not ok:
            raise AssertionError(f"serving {name}/{label}: {out[label]}")
    return out


def _flat_plan(n, seed):
    g = np.random.default_rng(seed)
    dead = g.choice(n, int(SERVING_DELETE * n), replace=False)
    live = np.setdiff1d(np.arange(n), dead)
    return {
        "dead": dead,
        "allow": np.sort(g.choice(live, int(SERVING_FILTER * len(live)), replace=False)),
        "allow_small": np.sort(g.choice(live, SERVING_FILTER_IDS, replace=False)),
        "readd": np.sort(dead)[:SERVING_READD],  # re-added rows: the deleted rows' vectors
    }


def _flat_sequence(idx, base, batches, plan, q, stage=None):
    """The flat serving sequence on ``idx``: fill by adds, search, delete
    (compacting), search, filtered searches, re-add, search. Returns the
    searches ``{label: (k, allowed live ids, (dists, ids))}``, the stable
    id -> row map and the seconds of each mutation."""
    from vectordb_retrieval_tpu_torch.utils.device import synchronize

    n = base.shape[0]
    secs = {}
    searches = {}
    if stage is not None:
        stage[0] = "add"
    t = time.perf_counter()
    for part in np.array_split(np.arange(n), batches):
        idx.add(base[part[0] : part[-1] + 1])
    synchronize(idx.device)
    secs["add"] = time.perf_counter() - t
    secs["capacity_filled"] = idx.capacity
    alive = np.arange(n)
    if stage is not None:
        stage[0] = "search"
    for k in SERVING_KS:
        searches[f"filled_k{k}"] = (k, alive, idx.search(q, k))
    t = time.perf_counter()
    deleted = idx.delete(plan["dead"])
    synchronize(idx.device)
    secs["delete"] = time.perf_counter() - t
    if deleted != len(plan["dead"]):
        raise AssertionError(f"delete removed {deleted} of {len(plan['dead'])}")
    secs["capacity_after_delete"] = idx.capacity
    alive = np.setdiff1d(alive, plan["dead"])
    for k in SERVING_KS:
        searches[f"deleted_k{k}"] = (k, alive, idx.search(q, k))
    k = SERVING_KS[-1]
    searches["filter_10pct"] = (k, plan["allow"], idx.search(q, k, filter_ids=plan["allow"]))
    searches["filter_1000"] = (k, plan["allow_small"],
                               idx.search(q, k, filter_ids=plan["allow_small"]))
    first = idx._next_id
    t = time.perf_counter()
    new = idx.add(base[plan["readd"]])
    synchronize(idx.device)
    secs["readd"] = time.perf_counter() - t
    if not np.array_equal(new, np.arange(first, first + len(plan["readd"]))) or first != n:
        raise AssertionError("re-added ids do not continue from next_id")
    alive = np.concatenate([alive, new])
    for k in SERVING_KS:
        searches[f"readded_k{k}"] = (k, alive, idx.search(q, k))
    row_of = np.concatenate([np.arange(n), plan["readd"]])
    return searches, row_of, secs


def _flat_data(shape, sift):
    """(base rows, 256 queries) of one serving shape."""
    if shape["name"] == "sift1m_surrogate":
        return sift["train"], sift["rows"]["exact"]["queries"]
    g = np.random.default_rng(SEED + 11)
    return (g.standard_normal((shape["n"], shape["d"]), dtype=np.float32),
            g.standard_normal((BATCH, shape["d"]), dtype=np.float32))


def phase_serving_flat(card: str, shape, sift, worst: dict) -> dict:
    """One MutableFlatIndex on the card through the serving sequence, each
    search held to the exact top-k over its allowed live rows; QPS and the
    scan's device time; save -> load and the snapshot handoff; then the
    same sequence on a host index (64 queries) against the card."""
    import torch

    from vectordb_retrieval_tpu_torch import serving
    from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher
    from vectordb_retrieval_tpu_torch.ops import kernels

    name = f"serving_flat/{shape['name']}"
    base, q = _flat_data(shape, sift)
    metric = shape["metric"]
    plan = _flat_plan(shape["n"], SEED + 12)
    launched, stage, compacts = {}, ["add"], []
    with capture_launch_inputs(launched, stage):
        kernels.reset_launch_counts()
        idx = serving.MutableFlatIndex(shape["d"], metric=metric)
        _timed_compact(idx, compacts)
        searches, row_of, secs = _flat_sequence(idx, base, shape["batches"], plan, q, stage)
        launches = dict(kernels.LAUNCHES)
        capacity = idx.capacity
        k = SERVING_KS[-1]
        # the device time of one batch: the filter's penalty, the scan
        qd = torch.as_tensor(q, device=DEV)
        scan_ms = time_ms(lambda: idx.device_search(qd, k), prime=True)
        filtered_ms = time_ms(lambda: idx.device_search(qd, k, plan["allow"]), prime=True)
        allow_dev = torch.as_tensor(plan["allow"], device=DEV)
        pen_ms = time_ms(lambda: torch.isin(idx._slot_ids_device(), allow_dev), prime=True)
        qps = {}
        for label, fid in (("unfiltered", None), ("filtered_10pct", plan["allow"])):
            elapsed, batches, passes = _qps(
                lambda qq, kk, fid=fid: idx.device_search(qq, kk, fid), qd, BATCH, k,
                capacity, f"{name}/{label}")
            qps[label] = {"qps": batches * BATCH / elapsed, "ms_per_batch": elapsed / batches * 1e3,
                          "batches_on_clock": batches * passes}
        before = dict(kernels.LAUNCHES)
        # save -> load on the card: the same ids
        stage[0] = "persist"
        path = os.path.join(OUT_DIR, "serving", shape["name"])
        t = time.perf_counter()
        idx.save(path)
        loaded = serving.MutableFlatIndex.load(path)
        load_s = time.perf_counter() - t
        d0, i0 = idx.search(q, k)
        d1, i1 = loaded.search(q, k)
        del loaded
        shutil.rmtree(path)
        # the snapshot handoff (compacts first): ANNSearcher's exact search
        stage[0] = "snapshot"
        snap = ANNSearcher()
        snap.attach(idx.to_artifact())
        _, is_ = snap.batch_search(q, k)
        for key, v in kernels.LAUNCHES.items():
            launches[key] += v - before[key]
    check_launched(launched, name, worst)
    vec_of = lambda ids: base[row_of[ids]]  # noqa: E731
    checks = _hold_to_exact(name, vec_of, q, searches, metric, HOST_MIN_AGREE)
    persist_same = bool(np.array_equal(i0, i1) and np.array_equal(d0, d1))
    snap_agree, _ = _multiset_agreement(*(_id_classes(vec_of, q, x, metric) for x in (i0, is_)), k)
    snap_raw, _ = _multiset_agreement(i0, is_, k)

    host = serving.MutableFlatIndex(shape["d"], metric=metric, device="cpu")
    t = time.perf_counter()
    host_searches, _, _ = _flat_sequence(host, base, shape["batches"], plan, q[:HOST_QUERIES])
    host_s = time.perf_counter() - t
    vs_host = {}
    for label, (k_, _, (_, hi)) in host_searches.items():
        ci = searches[label][2][1][:HOST_QUERIES]
        agree, _ = _multiset_agreement(
            *(_id_classes(vec_of, q[:HOST_QUERIES], x, metric) for x in (ci, hi)), k_)
        vs_host[label] = agree
    out = {
        "phase": "serving_flat", "shape": [shape["n"], shape["d"]], "config": shape["name"],
        "metric": metric, "card": card, "capacity_filled": secs["capacity_filled"],
        "capacity_after_delete": secs["capacity_after_delete"], "capacity_timed": capacity,
        "scan_filled": "dense" if secs["capacity_filled"] <= serving.FLAT_CHUNK_ROWS else "streamed",
        "scan_timed": "dense" if capacity <= serving.FLAT_CHUNK_ROWS else "streamed",
        "add_rows_per_s": shape["n"] / secs["add"], "readd_rows_per_s": SERVING_READD / secs["readd"],
        "delete_ids_per_s": len(plan["dead"]) / secs["delete"], "delete_s": secs["delete"],
        "compact_seconds": compacts, "checks": checks,
        "save_load_ids_identical": persist_same, "save_load_s": load_s,
        "snapshot_id_agreement": snap_agree, "snapshot_raw_id_agreement": snap_raw,
        "qps": qps, "batch_device_ms": scan_ms, "filtered_batch_device_ms": filtered_ms,
        "filter_penalty_ms": pen_ms,
        "host_clock_over_device_batch": qps["unfiltered"]["ms_per_batch"] / scan_ms,
        "card_vs_host": vs_host, "host_queries": HOST_QUERIES, "host_seconds": host_s,
        "launches": launches,
    }
    emit(out)
    ok = (persist_same and snap_agree == 1.0
          and min(vs_host.values()) >= HOST_MIN_AGREE)
    if not ok:
        raise AssertionError(f"{name}: save/load {persist_same}, snapshot {snap_agree}, "
                             f"host {vs_host}")
    del idx, snap, host
    torch.cuda.empty_cache()
    return out


def _ivf_serving_stages(idx, qd, k):
    """One unfiltered batch of a MutableIVFIndex cut into the stages of the
    route it takes (fused: K1 f32; masked: the masked stream), each on the
    inputs the search gives it; the staged result must equal the search."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import ivf
    from vectordb_retrieval_tpu_torch.ops import kernels

    b = qd.shape[0]
    route = idx.route(b)
    eff = idx.probe_budget()
    slot_ids, vecs, sqn = idx._slot_ids, idx._list_vecs, idx._list_sqn
    n_bkt, L = slot_ids.shape
    slack = ivf._BLOCKMIN_SLACK
    k = min(k, n_bkt * L)
    probes = ivf._coarse_probes(qd, idx._coarse, eff)
    stages = {"coarse": lambda: ivf._coarse_probes(qd, idx._coarse, eff)}
    coding = ivf.ListCoding(vecs, sqn, qd)
    if route == "fused":
        w = ivf._fused_w(L)
        pen = ivf._fused_pen(slot_ids, sqn, "l2").reshape(-1, w)
        payload = vecs.reshape(n_bkt * L, -1)
        qk = coding.index_queries()
        stages["dist_blockmin"] = lambda: kernels.dist_blockmin(qk, payload, pen, w=w)
        bm = stages["dist_blockmin"]()
        stages["select"] = lambda: ivf._probed_blocks(bm, probes, n_bkt, L // w, k + slack)
    elif route == "masked":
        w = ivf._BLOCKMIN_W
        stages["masked_stream"] = lambda: ivf._masked_minima(probes, None, slot_ids, coding,
                                                             "l2", w)
        bm = stages["masked_stream"]()
        blk_ids = torch.arange(bm.shape[1], device=DEV).expand(b, -1)
        stages["select"] = lambda: ivf._smallest_blocks(bm, blk_ids, min(k + slack, bm.shape[1]))
    else:
        raise AssertionError(f"a batch of {b} took the probe scan")
    sel_vals, blk = stages["select"]()
    scorer = ivf._block_scorer(coding, slot_ids, w, "l2")
    stages["rescore"] = lambda: ivf._rescore_blocks(blk, sel_vals, scorer, k)
    if not torch.equal(stages["rescore"]()[1], idx.device_search(qd, k)[1]):
        raise AssertionError("serving IVF: the stage split differs from the search")
    return route, w, stages


def _ivf_sequence(idx, base, row_of, rest_batches, dead, plan, q, stage=None):
    """The IVF serving sequence after the build: add the other half in
    batches, delete, search (unfiltered and filtered). Returns the searches
    and the seconds of each mutation."""
    from vectordb_retrieval_tpu_torch.utils.device import synchronize

    secs = {}
    if stage is not None:
        stage[0] = "add"
    t = time.perf_counter()
    for part in rest_batches:
        idx.add(base[part])
    synchronize(idx.device)
    secs["add"] = time.perf_counter() - t
    t = time.perf_counter()
    if idx.delete(dead) != len(dead):
        raise AssertionError("serving IVF: delete missed live ids")
    synchronize(idx.device)
    secs["delete"] = time.perf_counter() - t
    if stage is not None:
        stage[0] = "search"
    k = SERVING_KS[-1]
    alive = np.setdiff1d(np.arange(len(row_of)), dead)
    searches = {
        "unfiltered": (k, alive, idx.search(q, k)),
        "filter_10pct": (k, plan["allow"], idx.search(q, k, filter_ids=plan["allow"])),
        "filter_1000": (k, plan["allow_small"], idx.search(q, k, filter_ids=plan["allow_small"])),
    }
    return searches, secs


def phase_serving_ivf(card: str, sift, worst: dict) -> dict:
    """MutableIVFIndex(nlist=1024, nprobe=32) on the SIFT surrogate: built
    over a seeded random half, the other half added in 10 batches (bucket
    growth), 20 % deleted, then unfiltered and filtered searches; recall@100
    against exact search over the live rows (gated), filtered answers only
    allowed live ids; save -> load and the snapshot handoff; the card
    against a host replay from the save made right after the build."""
    import torch

    from vectordb_retrieval_tpu_torch import serving
    from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher
    from vectordb_retrieval_tpu_torch.ops import kernels

    name = "serving_ivf/sift1m_surrogate"
    base, q = sift["train"], sift["rows"]["exact"]["queries"]
    n = base.shape[0]
    g = np.random.default_rng(SEED + 21)
    perm = g.permutation(n)
    init, rest = perm[: n // 2], perm[n // 2 :]
    row_of = np.concatenate([init, rest])  # stable id -> row of base
    rest_batches = np.array_split(rest, SERVING_IVF["add_batches"])
    dead = g.choice(n, int(SERVING_IVF["delete"] * n), replace=False)
    alive = np.setdiff1d(np.arange(n), dead)
    plan = {"allow": np.sort(g.choice(alive, int(SERVING_FILTER * len(alive)), replace=False)),
            "allow_small": np.sort(g.choice(alive, SERVING_FILTER_IDS, replace=False))}
    built_path = os.path.join(OUT_DIR, "serving", "ivf_built")
    launched, stage, compacts = {}, ["build"], []
    with capture_launch_inputs(launched, stage):
        kernels.reset_launch_counts()
        t = time.perf_counter()
        idx = serving.MutableIVFIndex(base[init], nlist=SERVING_IVF["nlist"],
                                      nprobe=SERVING_IVF["nprobe"])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        build_launches = dict(kernels.LAUNCHES)
        _timed_compact(idx, compacts)
        idx.save(built_path)
        physical0, nb0 = int(idx._slot_ids.shape[0]), idx._nb
        searches, secs = _ivf_sequence(idx, base, row_of, rest_batches, dead, plan, q, stage)
        launches = dict(kernels.LAUNCHES)
        physical1, nb1 = int(idx._slot_ids.shape[0]), idx._nb
        k = SERVING_KS[-1]
        qd = torch.as_tensor(q, device=DEV)
        route, w, stages = _ivf_serving_stages(idx, qd, k)
        stage_ms = {s: time_ms(fn, prime=True) for s, fn in stages.items()}
        batch_ms = time_ms(lambda: idx.device_search(qd, k), prime=True)
        filtered_ms = time_ms(lambda: idx.device_search(qd, k, filter_ids=plan["allow"]),
                              prime=True)
        allow_dev = torch.as_tensor(serving._pad_allow_list(plan["allow"]), device=DEV)
        pen_ms = time_ms(lambda: serving._allow_penalty(idx._slot_ids, allow_dev), prime=True)
        qps = {}
        for label, fid in (("unfiltered", None), ("filtered_10pct", plan["allow"])):
            elapsed, batches, passes = _qps(
                lambda qq, kk, fid=fid: idx.device_search(qq, kk, filter_ids=fid), qd, BATCH, k,
                idx._next_id, f"{name}/{label}")
            qps[label] = {"qps": batches * BATCH / elapsed, "ms_per_batch": elapsed / batches * 1e3,
                          "batches_on_clock": batches * passes}
        before = dict(kernels.LAUNCHES)
        stage[0] = "persist"
        path = os.path.join(OUT_DIR, "serving", "ivf_saved")
        idx.save(path)
        loaded = serving.MutableIVFIndex.load(path)
        d0, i0 = idx.search(q, k)
        d1, i1 = loaded.search(q, k)
        loaded_route = loaded.route(BATCH)
        del loaded
        shutil.rmtree(path)
        # the snapshot handoff, both exact at full probe
        stage[0] = "snapshot"
        full_live = idx.search(q, k, nprobe=idx.nlist)
        snap = ANNSearcher(nprobe=idx.nlist)
        snap.attach(idx.to_artifact())
        _, is_ = snap.batch_search(q, k)
        snap32 = ANNSearcher(nprobe=SERVING_IVF["nprobe"])
        snap32.attach(snap.artifact)
        _, i32 = snap32.batch_search(q, k)
        for key, v in kernels.LAUNCHES.items():
            launches[key] += v - before[key]
    check_launched(launched, name, worst)

    vec_of = lambda ids: base[row_of[ids]]  # noqa: E731
    exact_ids, _ = _exact_live(vec_of, alive, q, k, "l2")
    recall = _recall(searches["unfiltered"][2][1], exact_ids, k)
    recall_snap32 = _recall(i32, exact_ids, k)
    filtered = {}
    for label in ("filter_10pct", "filter_1000"):
        _, allow, (_, ids) = searches[label]
        want, _ = _exact_live(vec_of, allow, q, k, "l2")
        filtered[label] = {"recall": _recall(ids, want, k),
                           "ids_allowed_and_live": bool(np.isin(ids[ids >= 0], allow).all())}
    cls = lambda ids: _id_classes(vec_of, q, ids, "l2")  # noqa: E731
    persist_agree, _ = _multiset_agreement(cls(i0), cls(i1), k)
    snap_agree, _ = _multiset_agreement(cls(full_live[1]), cls(is_), k)

    host = serving.MutableIVFIndex.load(built_path, device="cpu")
    t = time.perf_counter()
    host_searches, _ = _ivf_sequence(host, base, row_of, rest_batches, dead, plan, q[:HOST_QUERIES])
    host_s = time.perf_counter() - t
    vs_host = {}
    shutil.rmtree(built_path)
    for label, (k_, _, (_, hi)) in host_searches.items():
        ci = searches[label][2][1][:HOST_QUERIES]
        vs_host[label] = _multiset_agreement(
            *(_id_classes(vec_of, q[:HOST_QUERIES], x, "l2") for x in (ci, hi)), k_)[0]
    out = {
        "phase": "serving_ivf", "config": "sift1m_surrogate", "shape": [n, 128],
        "nlist": SERVING_IVF["nlist"], "nprobe": SERVING_IVF["nprobe"], "card": card,
        "build_s": build_s, "build_launches": build_launches,
        "buckets_after_build": nb0, "physical_after_build": physical0,
        "buckets_after_adds": nb1, "physical_after_adds": physical1,
        "buckets_after_compact": idx._nb,
        "bucket_len": idx._L, "probe_budget": idx.probe_budget(),
        "add_rows_per_s": len(rest) / secs["add"], "delete_ids_per_s": len(dead) / secs["delete"],
        "compact_seconds": compacts, "route": route, "loaded_route": loaded_route, "w": w,
        f"recall@{k}": recall, "min_recall": SERVING_IVF_MIN_RECALL,
        f"snapshot_np{SERVING_IVF['nprobe']}_recall@{k}": recall_snap32,
        "filtered": filtered, "save_load_id_agreement": persist_agree,
        "snapshot_full_probe_id_agreement": snap_agree,
        "qps": qps, "stage_ms": stage_ms, "batch_device_ms": batch_ms,
        "filtered_batch_device_ms": filtered_ms, "filter_penalty_ms": pen_ms,
        "host_clock_over_device_batch": qps["unfiltered"]["ms_per_batch"] / batch_ms,
        "card_vs_host": vs_host, "host_queries": HOST_QUERIES, "host_seconds": host_s,
        "launches": launches,
    }
    emit(out)
    ok = (recall >= SERVING_IVF_MIN_RECALL and nb1 > nb0
          and all(f["ids_allowed_and_live"] for f in filtered.values())
          and persist_agree == 1.0 and snap_agree == 1.0
          and min(vs_host.values()) >= HOST_MIN_AGREE
          and launches["assign"] >= 1 + SERVING_IVF["add_batches"])
    if not ok:
        raise AssertionError(f"{name}: recall {recall}, filtered {filtered}, save/load "
                             f"{persist_agree}, snapshot {snap_agree}, host {vs_host}, "
                             f"launches {launches}")
    del idx, snap, snap32, host
    torch.cuda.empty_cache()
    return out


# ---- 5f. out of core --------------------------------------------------------

BIGCORPUS_DIR = os.path.join(OUT_DIR, "bigcorpus")
# validate_bigcorpus runs at its defaults (4M x 128, IVF1024,SQ8 np128, k 20)
BIGCORPUS_ARGS = ["--data-dir", BIGCORPUS_DIR, "--keep"]
# benchmark_results/round2_bigcorpus/validation_runs.jsonl line 2: the JAX
# package's IVF1024,SQ8 np128 row at 4M x 128 (k 20, 256 queries); its
# times are CPU times and no baseline
BIGCORPUS_COMMITTED_RECALL = 0.5158
BIGCORPUS_GT_CHECK = 64
GRAPH_STREAM_MARGIN = 0.05  # tests/data/test_storage.py's resident-class bound
SIFT_STORE = os.path.join(OUT_DIR, "sift_store", "sift_base.bin")


# A process that starts the out-of-core check: made first thing in main(),
# while this process is small. The card's machine carries a parent's
# resident size into a child's peak RSS (ru_maxrss and VmHWM alike), so
# the check's own process must descend from a small one.
_LAUNCHER = (
    "import json, subprocess, sys\n"
    "line = sys.stdin.readline()\n"
    "if line:\n"
    "    p = subprocess.run(json.loads(line), capture_output=True, text=True, timeout=900)\n"
    "    sys.stdout.write(json.dumps([p.returncode, p.stdout, p.stderr]))\n"
)


def _start_launcher():
    return subprocess.Popen([sys.executable, "-c", _LAUNCHER], cwd=REPO, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, start_new_session=True)


def _stop_launcher(launcher) -> None:
    """Stop the launcher and whatever it started (its own session)."""
    if launcher.poll() is None:
        import signal

        os.killpg(launcher.pid, signal.SIGKILL)
        launcher.wait()


def phase_out_of_core(card: str, worst: dict, launcher) -> dict:
    """``python -m vectordb_retrieval_tpu_torch.bench.validate_bigcorpus``
    in a fresh process at its defaults (peak RSS is a process-lifetime
    peak): 4M x 128 ``random`` with ``storage: memmap``, streamed ground
    truth, the streamed IVF1024,SQ8 build, search. Then, in this process:
    the chunked upload's GB/s, the streamed ground truth of 64 queries
    against a resident exact search, and the same streamed build under the
    launch capture (its K3 and K1 u8 launches held to their plain
    versions)."""
    import torch

    from vectordb_retrieval_tpu_torch.bench import validate_bigcorpus
    from vectordb_retrieval_tpu_torch.data import datasets
    from vectordb_retrieval_tpu_torch.data.storage import corpus_to_device
    from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
    from vectordb_retrieval_tpu_torch.ops import distances as dops
    from vectordb_retrieval_tpu_torch.ops import kernels

    args = validate_bigcorpus.parse_args(BIGCORPUS_ARGS)
    cmd = [sys.executable, "-m", "vectordb_retrieval_tpu_torch.bench.validate_bigcorpus"]
    t = time.perf_counter()
    sent, _ = launcher.communicate(json.dumps(cmd + BIGCORPUS_ARGS) + "\n", timeout=960)
    sub_s = time.perf_counter() - t
    rc, stdout, stderr = json.loads(sent)
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    if not lines:
        raise AssertionError(f"validate_bigcorpus rc {rc}:\n{stdout}\n{stderr}")
    res = json.loads(lines[-1])  # exit code 1: peak RSS over the corpus, gated below
    res["returncode"] = rc
    k = args.k
    min_recall = BIGCORPUS_COMMITTED_RECALL - RECALL_MARGIN

    ds = datasets.Dataset("random", data_dir=args.data_dir,
                          options=validate_bigcorpus.dataset_options(args), device=args.device).load()
    if not isinstance(ds.train_vectors, np.memmap):
        raise AssertionError("the cached 4M corpus did not reload as a memmap")
    torch.cuda.synchronize()
    t = time.perf_counter()
    x = corpus_to_device(ds.train_vectors)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t
    gbps = x.numel() * 4 / put_s / 1e9
    rows = np.sort(np.random.default_rng(SEED).choice(x.shape[0], 64, replace=False))
    upload_exact = bool(np.array_equal(x[torch.as_tensor(rows, device=DEV)].cpu().numpy(),
                                       np.asarray(ds.train_vectors[rows])))
    qs = ds.test_vectors[:BIGCORPUS_GT_CHECK]
    _, ids = dops.exact_search(qs, x, k, refine=True)
    ids = ids.cpu().numpy()
    del x
    torch.cuda.empty_cache()
    gt = ds.ground_truth[:BIGCORPUS_GT_CHECK, :k]
    mm = ds.train_vectors
    want = np.sort(np.stack([_exact_distances(mm[np.sort(r)], qs[i : i + 1], "l2")[0]
                             for i, r in enumerate(ids)]), 1)
    got = np.sort(np.stack([_exact_distances(mm[np.sort(r)], qs[i : i + 1], "l2")[0]
                            for i, r in enumerate(gt)]), 1)
    gt_err = float((np.abs(got - want) / np.abs(want).max(1, keepdims=True)).max())
    gt_ids_equal = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, gt)]))

    launched, stage = {}, ["bigcorpus/build"]
    with capture_launch_inputs(launched, stage):
        kernels.reset_launch_counts()
        algo = CompositeAlgorithm(
            dimension=args.dim,
            indexer={"type": "IVFIndexer", "index_type": f"IVF{args.nlist},{args.coding}"},
            searcher={"type": "ANNSearcher", "nprobe": args.nprobe}, metric="l2")
        t = time.perf_counter()
        algo.build_index(ds.train_vectors)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        stage[0] = "bigcorpus/search"
        _, got_ids = algo.batch_search(ds.test_vectors, k)
        launches = dict(kernels.LAUNCHES)
    check_launched(launched, "out_of_core", worst)
    recall_here = _recall(got_ids, ds.ground_truth[:, :k], k)
    meta = algo.artifact.metadata
    out = {
        "phase": "out_of_core", "card": card, "validate_bigcorpus": res,
        "subprocess_seconds": sub_s, "min_recall": min_recall,
        "chunked_device_put_gb_per_s": gbps, "chunked_device_put_s": put_s,
        "upload_rows_exact": upload_exact,
        "gt_check_queries": BIGCORPUS_GT_CHECK, "gt_vs_resident_max_rel_err": gt_err,
        "gt_vs_resident_id_agreement": gt_ids_equal, "gt_tol": GT_REL_TOL,
        "in_process_build_s": build_s, "in_process_build_seconds": dict(algo.indexer.build_seconds),
        f"in_process_recall@{k}": recall_here, "route": _row_mode(algo),
        "n_buckets": meta["n_buckets"], "bucket_len": meta["max_list_len"],
        "launches": launches,
    }
    emit(out)
    ok = (res["rss_growth_under_corpus"] and res["built_streaming"]
          and res[f"recall@{k}"] >= min_recall
          and upload_exact and gt_err <= GT_REL_TOL and meta.get("built_streaming")
          and recall_here >= min_recall and launches["dist_blockmin_u8"] >= 1
          and launches["assign"] >= 1)
    if not ok:
        raise AssertionError(f"out of core: {out}")
    del algo
    torch.cuda.empty_cache()
    shutil.rmtree(args.data_dir, ignore_errors=True)
    return launches


def phase_graph_stream(card: str, sift, worst: dict) -> dict:
    """The SIFT surrogate written into a BigStore in chunks, then the
    streamed block-graph build of its hnsw row (M 16, efSearch 64, block
    mode); recall@100 on the 256 surrogate queries against the in-memory
    row's less 0.05."""
    import torch

    from vectordb_retrieval_tpu_torch.data.storage import BigStore
    from vectordb_retrieval_tpu_torch.models.composite import CompositeAlgorithm
    from vectordb_retrieval_tpu_torch.ops import kernels

    row = sift["rows"]["hnsw"]
    indexer, nprobe = IVF_CONFIGS[0]["rows"]["hnsw"]
    base = sift["train"]
    t = time.perf_counter()
    with BigStore.create(SIFT_STORE, base.shape[1]) as w:
        for s in range(0, base.shape[0], 262_144):
            w.append(base[s : s + 262_144])
    write_s = time.perf_counter() - t
    store = BigStore.open(SIFT_STORE)
    launched, stage = {}, ["graph_stream/build"]
    with capture_launch_inputs(launched, stage):
        kernels.reset_launch_counts()
        algo = CompositeAlgorithm(dimension=base.shape[1], indexer=dict(indexer),
                                  searcher={"type": "ANNSearcher", "nprobe": nprobe}, metric="l2")
        t = time.perf_counter()
        algo.build_index(store)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        stage[0] = "graph_stream/search"
        _, ids = algo.batch_search(row["queries"], row["k"])
        launches = dict(kernels.LAUNCHES)
    check_launched(launched, "graph_stream", worst)
    recall = _recall(ids, row["gt"], row["k"])
    meta = algo.artifact.metadata
    out = {
        "phase": "graph_stream", "config": "sift1m_surrogate", "card": card,
        "store_write_s": write_s, "build_s": build_s, "mode": meta["mode"],
        "built_streaming": meta.get("built_streaming"), "selfcheck_recall": meta["selfcheck_recall"],
        "n_blocks": meta["n_blocks"], "block_len": meta["block_len"],
        "n_entries": meta["n_entries"], f"recall@{row['k']}": recall,
        "resident_recall": row["recall"], "margin": GRAPH_STREAM_MARGIN,
        "index_memory_mb": algo.artifact.device_nbytes() / 2**20, "launches": launches,
    }
    emit(out)
    ok = (meta.get("built_streaming") and meta["mode"] == "block"
          and recall >= row["recall"] - GRAPH_STREAM_MARGIN
          and launches["slab_dots"] >= 1 and launches["assign"] >= 1)
    if not ok:
        raise AssertionError(f"graph stream: {out}")
    del algo
    torch.cuda.empty_cache()
    os.remove(SIFT_STORE)
    return launches


# ---- 5g. row-sharded ------------------------------------------------------

# configs/sift1m.yaml's rows row-sharded (configs/benchmark_sharded.yaml's
# indexers) with every shard on the one card: nlist a shard is 1024 / shards,
# so the shards together hold IVF1024's 1,024 lists; nprobe counts a shard's
# own lists (np8 for Flat, np16 for SQ8 and PQ32); the graph in auto mode
# (block mode at 250,000 and 125,000 rows a shard)
SHARDED_SHARDS = (4, 8)
# K1's mode in each sharded IVF search: f32 lists (as the JAX package builds
# them), u8 codes, bf16 reconstructions
_SHARDED_K1 = {"ivf_flat_sharded": "dist_blockmin", "ivf_sq8_sharded": "dist_blockmin_u8",
               "ivf_pq_sharded": "dist_blockmin_bf16"}
# exact search over these meshes of one card: db shards, query blocks, and
# the process axis through NCCL as a world of one
SHARDED_EXACT_MESHES = ("db4", "db8", "q2xdb4", "db1", "dcn1xdb4")
SHARDED_SERVING_IVF = {"nlist": 1024, "nprobe": 32, "add_batches": 10, "delete": 0.20}
SHARDED_TIMING = {"reps": 5, "warmup": 1}


def _sharded_config(n_shards):
    nlist = 1024 // n_shards
    return {
        "name": f"sift1m_surrogate_db{n_shards}",
        "source": ("configs/sift1m.yaml ivf_flat, ivf_sq8, ivf_pq, hnsw on "
                   "data/sift1m_synth, row-sharded with configs/benchmark_sharded.yaml's "
                   f"indexers over {n_shards} shards of one card"),
        "dataset": "sift1m", "metric": "l2", "n": SIFT_ROWS, "d": 128, "topk": 100,
        "queries": 256, "batch": 256, "gt_k": 100, "shards": n_shards,
        "rows": {  # exact search: phase_sharded, held modulo distance ties
            "ivf_flat": ({"type": "ShardedIVFIndexer", "index_key": f"IVF{nlist},Flat",
                          "nprobe": 8}, 8),
            "ivf_sq8": ({"type": "ShardedIVFIndexer", "index_key": f"IVF{nlist},SQ8",
                         "nprobe": 16}, 16),
            "ivf_pq": ({"type": "ShardedIVFIndexer", "index_key": f"IVF{nlist},PQ32",
                        "nprobe": 16}, 16),
            "hnsw": ({"type": "ShardedGraphIndexer", "M": 16, "efConstruction": 200,
                      "efSearch": 64}, 64),
        },
    }


SHARDED_CONFIGS = tuple(_sharded_config(n) for n in SHARDED_SHARDS)


def _sharded_row_line(algo, bsz) -> dict:
    """A sharded row's own numbers: mesh, index bytes, build seconds by
    part, and for IVF the route each shard takes at a batch of ``bsz``."""
    from vectordb_retrieval_tpu_torch.ops.ivf import ivf_route

    art = algo.artifact
    meta = art.metadata
    line = {"phase": "sharded_main_path", "kind": art.kind, "mesh": dict(art.mesh.shape),
            "index_bytes": art.device_nbytes(),
            "build_seconds": getattr(algo.indexer, "build_seconds", None)}
    if art.kind.startswith("ivf"):
        nb, length = art.data["slot_ids"].shard_shape
        budget = algo.searcher._nprobe()
        line.update({"index_key": meta["index_key"], "n_buckets": nb, "bucket_len": length,
                     "nprobe_lists": algo.searcher._sharded_probe_lists(),
                     "probe_budget": budget,
                     "routes": [ivf_route(bsz, budget, nb, length)] * art.mesh.size("db")})
    elif art.kind == "graph_sharded":
        line.update({key: meta.get(key) for key in
                     ("mode", "rows_per_shard", "degree", "efSearch", "n_blocks", "block_len")})
    return line


@contextlib.contextmanager
def _fan_out_capture(store: dict):
    """While active, keep in ``store`` the arguments of the last sharded
    search's fan-out (queries, mesh, axes, the per-shard search, k)."""
    from vectordb_retrieval_tpu_torch.parallel import serving as pserving
    from vectordb_retrieval_tpu_torch.parallel import sharded, sharded_graph, sharded_ivf

    orig = sharded_ivf.fan_out
    mods = (sharded, sharded_graph, sharded_ivf, pserving)

    def capture(queries, mesh, axis, q_axis, local, out_k):
        store.update(queries=queries, mesh=mesh, axis=axis, q_axis=q_axis, local=local,
                     out_k=out_k)
        return orig(queries, mesh, axis, q_axis, local, out_k)

    for m in mods:
        m.fan_out = capture
    try:
        yield store
    finally:
        for m in mods:
            m.fan_out = orig


def _shard_split(search) -> dict:
    """Device ms of one primed batch of ``search()``, split into the
    per-shard searches (summed over every shard of every ring), the merge
    (copies to the ring's first device and the tie-free cut, with the
    process axis's all_gather where the mesh has one) and the rest."""
    import torch

    from vectordb_retrieval_tpu_torch.parallel.sharded_ivf import gather_merge

    store = {}
    with _fan_out_capture(store):
        search()
    mesh, axis, q_axis, local = store["mesh"], store["axis"], store["q_axis"], store["local"]
    rings = mesh.rings(axis, q_axis)
    q = store["queries"]
    blocks = torch.tensor_split(q, len(rings)) if q_axis is not None else (q,)
    group = mesh.group if mesh.spans_processes(axis) else None
    shard_ms, merge_ms, parts_all = [], 0.0, []
    for qb, ring in zip(blocks, rings):
        qs = [qb.to(mesh.devices[c]) for c in ring]
        for qc, c in zip(qs, ring):
            shard_ms.append(time_ms(lambda qc=qc, c=c: local(qc, c), prime=True,
                                    **SHARDED_TIMING))
        parts = [local(qc, c) for qc, c in zip(qs, ring)]
        merge_ms += time_ms(lambda parts=parts: gather_merge(parts, store["out_k"], group),
                            prime=True, **SHARDED_TIMING)
        parts_all.append(parts)
    batch_ms = time_ms(search, prime=True, **SHARDED_TIMING)
    return {"batch_device_ms": batch_ms, "per_shard_ms": shard_ms,
            "shards_sum_ms": sum(shard_ms), "merge_ms": merge_ms,
            "rest_ms": batch_ms - sum(shard_ms) - merge_ms, "rings": len(rings),
            "shards_a_ring": len(rings[0])}


def _sharded_numbers(search, qd, k, n, name) -> dict:
    """The split of one primed batch and the QPS with ids on the host."""
    split = _shard_split(lambda: search(qd, k))
    elapsed, batches, passes = _qps(search, qd, BATCH, k, n, name)
    return dict(split, qps=batches * BATCH / elapsed, ms_per_batch=elapsed / batches * 1e3,
                batches_on_clock=batches * passes)


def _sharded_mesh(label):
    """(mesh, db axis, q axis) of one exact-search mesh label."""
    from vectordb_retrieval_tpu_torch import parallel as par

    if label == "q2xdb4":
        return par.make_mesh(8, ("q", "db"), (2, 4), devices=[DEV] * 8), "db", "q"
    if label == "dcn1xdb4":
        par.init_distributed(device=DEV)
        return par.make_multihost_mesh(devices=[DEV] * 4), ("dcn", "db"), None
    return par.make_mesh(devices=[DEV] * int(label[2:])), "db", None


def _hold_ids(name, train, q, d, ids, ref_d, ref_ids, k, scale) -> dict:
    """Ids equal to the reference's modulo exact distance ties (the
    surrogate's rows are integers), sorted distances to f32 rounding."""
    agree, _ = _multiset_agreement(*_distance_classes(train, q, ids, ref_ids), k)
    raw, _ = _multiset_agreement(ids, ref_ids, k)
    err = float(np.abs(np.sort(d, 1) - np.sort(ref_d, 1)).max())
    out = {"id_agreement": agree, "raw_id_agreement": raw, "max_abs_dist_err": err,
           "tol": GT_REL_TOL * scale}
    if agree < 1.0 or err > GT_REL_TOL * scale:
        raise AssertionError(f"sharded {name}: {out}")
    return out


def phase_sharded(card: str, sharded_paths, sift_path, unsharded: dict, worst: dict) -> dict:
    """The row-sharded path beyond the runner's rows, on the SIFT surrogate
    (256 queries, top-100, l2) with every shard on the card: exact search
    over db4, db8, q2 x db4, db1 and (dcn, db4) with NCCL as a world of one,
    each held to the single-device exact search; the db4 IVF-Flat artifact
    at full probe held to it too; the db4 IVF-Flat and graph artifacts on
    the host (card against host) and through save -> load -> reshard;
    ShardedMutableFlat on (replica 2, db 2) through the serving sequence,
    every search held to exact search over its allowed live rows;
    ShardedMutableIVF(nlist 1024, nprobe 32 a shard) over db4, built on a
    seeded half and grown by adds of the rest: partial-probe recall@100 and
    all-probe self-queries. The launch counts are set to 0 before these
    runs and read after them; then each search's device ms by part (the
    shards, the merge, the rest) and QPS beside the unsharded row's."""
    import torch
    import torch.distributed as dist

    from vectordb_retrieval_tpu_torch import parallel as par
    from vectordb_retrieval_tpu_torch.models import persist
    from vectordb_retrieval_tpu_torch.models.factory import ANNSearcher
    from vectordb_retrieval_tpu_torch.ops import distances as dops
    from vectordb_retrieval_tpu_torch.ops import kernels
    from vectordb_retrieval_tpu_torch.parallel import serving as pserving

    t_phase = time.perf_counter()
    base = sift_path["train"]
    q = sift_path["rows"]["exact"]["queries"]
    n, k = base.shape[0], SERVING_KS[-1]
    qd = torch.as_tensor(q, device=DEV)
    base_dev = torch.as_tensor(base, device=DEV)
    single = lambda qq, kk: dops.exact_search(qq, base_dev, kk, refine=True, device=DEV)  # noqa: E731
    ref_d, ref_i = (t.cpu().numpy() for t in single(qd, k))
    single_ms = time_ms(lambda: single(qd, k), prime=True, **SHARDED_TIMING)
    del base_dev
    torch.cuda.empty_cache()
    scale = float(np.abs(ref_d).max())
    db4 = next(p for p in sharded_paths if p["name"] == SHARDED_CONFIGS[0]["name"])
    searches = {}
    launched, stage = {}, ["exact"]
    with capture_launch_inputs(launched, stage):
        kernels.reset_launch_counts()
        t_main = time.perf_counter()
        # exact search over the meshes
        for label in SHARDED_EXACT_MESHES:
            stage[0] = f"exact_{label}"
            mesh, axis, q_axis = _sharded_mesh(label)
            xs, n_total = par.shard_database(base, mesh, axis)
            search = (lambda qq, kk, xs=xs, n_total=n_total, mesh=mesh, axis=axis, q_axis=q_axis:
                      par.sharded_exact_search(qq, xs, n_total, kk, mesh, db_axis=axis,
                                               q_axis=q_axis))
            d, i = (t.cpu().numpy() for t in search(qd, k))
            line = {"mesh": dict(mesh.shape), "index_bytes": xs.device_nbytes(),
                    "backend": dist.get_backend() if mesh.group is not None else None,
                    **_hold_ids(label, base, q, d, i, ref_d, ref_i, k, scale)}
            searches[label] = (search, line, n)
        # the db4 IVF-Flat artifact at full probe: exact search
        stage[0] = "ivf_flat_full_probe"
        flat = db4["rows"]["ivf_flat"]["algo"]
        full = ANNSearcher(metric="l2", nprobe=flat.artifact.metadata["nlist"],
                           device=[DEV] * flat.artifact.mesh.size("db"))
        full.attach(flat.artifact)
        d, i = full.batch_search(q, k)
        full_probe = _hold_ids("ivf_flat full probe", base, q, d, i, ref_d, ref_i, k, scale)
        # sharded serving: the flat index on (replica 2, db 2)
        stage[0] = "serving_flat"
        rmesh = par.make_mesh(4, ("replica", "db"), (2, 2), devices=[DEV] * 4)
        sflat = pserving.ShardedMutableFlat(base.shape[1], rmesh, q_axis="replica")
        plan = _flat_plan(n, SEED + 31)
        flat_searches, row_of, flat_secs = _flat_sequence(sflat, base, 10, plan, q, stage)
        # sharded serving: the IVF index over db4
        stage[0] = "serving_ivf_build"
        g = np.random.default_rng(SEED + 41)
        perm = g.permutation(n)
        init, rest = perm[: n // 2], perm[n // 2 :]
        ivf_row_of = np.concatenate([init, rest])
        t = time.perf_counter()
        sivf = pserving.ShardedMutableIVF(base[init], par.make_mesh(devices=[DEV] * 4),
                                          nlist=SHARDED_SERVING_IVF["nlist"],
                                          nprobe=SHARDED_SERVING_IVF["nprobe"])
        torch.cuda.synchronize()
        ivf_build_s = time.perf_counter() - t
        cap0 = sivf._capB_local
        stage[0] = "serving_ivf_add"
        t = time.perf_counter()
        for part in np.array_split(rest, SHARDED_SERVING_IVF["add_batches"]):
            sivf.add(base[part])
        torch.cuda.synchronize()
        ivf_add_s = time.perf_counter() - t
        dead = g.choice(n, int(SHARDED_SERVING_IVF["delete"] * n), replace=False)
        t = time.perf_counter()
        sivf.delete(dead)
        ivf_delete_s = time.perf_counter() - t
        alive = np.setdiff1d(np.arange(n), dead)
        stage[0] = "serving_ivf_search"
        _, ivf_ids = sivf.search(q, k)
        probe = g.choice(alive, BATCH, replace=False)
        self_d, self_i = sivf.search(base[ivf_row_of[probe]], 1, nprobe=sivf._capB_local)
        main_s = time.perf_counter() - t_main
        launches = dict(kernels.LAUNCHES)
    check_launched(launched, "sharded", worst)

    # the exact meshes' numbers (the process group stays up for dcn1xdb4)
    for label, (search, line, n_rows) in searches.items():
        line.update(_sharded_numbers(search, qd, k, n_rows, f"sharded/{label}"))
        emit({"phase": "sharded_exact", "mesh_label": label, "config": "sift1m_surrogate",
              "topk": k, "card": card, **line,
              "unsharded": {"batch_device_ms": single_ms,
                            "runner_qps": unsharded["exact"]["qps"]}})
    searches.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # the runner's sharded rows: split and QPS beside the unsharded rows
    for path in sharded_paths:
        for row, info in path["rows"].items():
            algo = info["algo"]
            search = lambda qq, kk, algo=algo: algo.device_kernel(qq, kk)  # noqa: E731
            numbers = _sharded_numbers(search, qd, k, n, f"{path['name']}/{row}")
            emit({**_sharded_row_line(algo, BATCH), "phase": "sharded_row",
                  "config": path["name"], "row": row, "recall@100": info["recall"],
                  "runner_qps": info["qps"], **numbers, "unsharded": unsharded.get(row),
                  "card": card})
    # card against host, and save -> load -> reshard, on db4's IVF-Flat and graph
    host_rows = {row: db4["rows"][row] for row in ("ivf_flat", "hnsw")}
    phase_card_vs_host(card, [{"name": db4["name"], "rows": host_rows, "train": base}])
    round_trips = {}
    for row, info in host_rows.items():
        algo = info["algo"]
        path = os.path.join(OUT_DIR, "sharded_artifacts", row)
        t = time.perf_counter()
        persist.save_artifact(algo.artifact, path)
        loaded = persist.load_artifact(path, device=DEV)
        s = ANNSearcher(metric="l2", device=[DEV] * algo.artifact.mesh.size("db"),
                        **algo.searcher.params)
        s.attach(loaded)  # reshards over the devices
        rt_s = time.perf_counter() - t
        same = bool(np.array_equal(s.batch_search(q, k)[1], algo.searcher.batch_search(q, k)[1]))
        round_trips[row] = {"ids_identical": same, "seconds": rt_s,
                            "mesh": dict(loaded.mesh.shape)}
        shutil.rmtree(path)
        if not same:
            raise AssertionError(f"sharded {row}: save -> load -> reshard changed the ids")
    emit({"phase": "sharded_persistence", "config": db4["name"], "round_trips": round_trips,
          "card": card})
    # serving: every flat search against exact search over its allowed live rows
    vec_of = lambda ids: base[row_of[ids]]  # noqa: E731
    flat_checks = _hold_to_exact("sharded_flat", vec_of, q, flat_searches, "l2", 1.0)
    flat_line = {"phase": "sharded_serving_flat", "mesh": dict(rmesh.shape), "q_axis": "replica",
                 "card": card, "capacity": sflat.capacity, "shard_fill": sflat.shard_fill().tolist(),
                 "index_bytes": sum(b.device_nbytes() for b in
                                    (sflat._vectors, sflat._sqnorms, sflat._pen)),
                 "add_rows_per_s": n / flat_secs["add"],
                 "delete_ids_per_s": len(plan["dead"]) / flat_secs["delete"],
                 "readd_rows_per_s": SERVING_READD / flat_secs["readd"], "checks": flat_checks,
                 **_sharded_numbers(lambda qq, kk: sflat.device_search(qq, kk), qd, k,
                                    sflat.capacity, "sharded_flat"),
                 "unsharded": unsharded["serving_flat"]}
    emit(flat_line)
    del sflat
    torch.cuda.empty_cache()
    ivf_vec_of = lambda ids: base[ivf_row_of[ids]]  # noqa: E731
    exact_ids, _ = _exact_live(ivf_vec_of, alive, q, k, "l2")
    recall = _recall(ivf_ids, exact_ids, k)
    hit = self_i[:, 0]
    self_ok = bool(np.isin(hit, alive).all() and (self_d[:, 0] == 0).all()
                   and np.array_equal(base[ivf_row_of[np.maximum(hit, 0)]], base[ivf_row_of[probe]]))
    ivf_line = {"phase": "sharded_serving_ivf", "mesh": dict(sivf.mesh.shape), "card": card,
                "nlist": sivf.nlist, "nprobe": sivf.nprobe, "bucket_len": sivf._L,
                "buckets_a_shard_after_build": cap0, "buckets_a_shard_after_adds": sivf._capB_local,
                "route": sivf.route(BATCH), "full_probe_route": sivf.route(BATCH, sivf._capB_local),
                "index_bytes": sum(b.device_nbytes() for b in
                                   (sivf._slot_ids, sivf._list_vecs, sivf._list_sqn, sivf._coarse)),
                "build_s": ivf_build_s, "add_rows_per_s": len(rest) / ivf_add_s,
                "delete_ids_per_s": len(dead) / ivf_delete_s, f"recall@{k}": recall,
                "min_recall": SERVING_IVF_MIN_RECALL, "self_queries": len(probe),
                "self_queries_found_at_distance_0": self_ok,
                **_sharded_numbers(lambda qq, kk: sivf.device_search(qq, kk), qd, k,
                                   sivf._next_id, "sharded_ivf"),
                "unsharded": unsharded["serving_ivf"]}
    emit(ivf_line)
    if recall < SERVING_IVF_MIN_RECALL or not self_ok or sivf._capB_local <= cap0:
        raise AssertionError(f"sharded serving IVF: {ivf_line}")
    del sivf
    torch.cuda.empty_cache()
    out = {"phase": "sharded_phase", "card": card, "launches": launches,
           "main_path_seconds": main_s, "full_probe_ivf_flat": full_probe,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


# ---- 7. entry points ---------------------------------------------------------

ENTRY_DIR = os.path.join(OUT_DIR, "entry")
ENTRY_TIMEOUT = 300
ROOFLINE_KEYS = ("kernel_flops_per_batch", "achieved_tflops", "kernel_bytes_per_batch",
                 "achieved_gbps")
SMOKE_CONFIG = os.path.join(REPO, "configs", "benchmark_config_smoke.yaml")


def _run_procs(argvs: dict, cwd: str, timeout: float) -> dict:
    """Run every argv of ``argvs`` at once from ``cwd``, each one's output
    in cwd/<name>.out / .err; name -> (exit code, stdout, seconds). A
    nonzero exit fails the run; every process is stopped before this
    returns."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {}
    try:
        for name, argv in argvs.items():
            out = open(os.path.join(cwd, f"{name}.out"), "w")
            err = open(os.path.join(cwd, f"{name}.err"), "w")
            proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=out, stderr=err)
            procs[name] = (proc, out, err, time.perf_counter())
        done = {}
        deadline = time.perf_counter() + timeout
        while len(done) < len(procs):  # each one's own seconds, whatever the order
            for name, (proc, out, err, t0) in procs.items():
                if name not in done and proc.poll() is not None:
                    done[name] = (proc.returncode, time.perf_counter() - t0)
            if time.perf_counter() > deadline:
                raise AssertionError(f"still running after {timeout} s: "
                                     f"{sorted(set(procs) - set(done))}")
            time.sleep(0.2)
    finally:
        for proc, out, err, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    results = {}
    for name, (rc, seconds) in done.items():
        with open(os.path.join(cwd, f"{name}.out")) as f:
            stdout = f.read()
        if rc != 0:
            with open(os.path.join(cwd, f"{name}.err")) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"{name} exited {rc}:\n{tail}")
        results[name] = (rc, stdout, seconds)
    return results


def _run_entries(cmds: dict) -> dict:
    """Run the port's CLIs (``python -m vectordb_retrieval_tpu_torch.<module>
    ...``, no ``--device``: the card is their default) all at once from
    ENTRY_DIR (see :func:`_run_procs`)."""
    return _run_procs(
        {name: [sys.executable, "-m", f"vectordb_retrieval_tpu_torch.{module}", *args]
         for name, (module, *args) in cmds.items()},
        ENTRY_DIR, ENTRY_TIMEOUT)


def _one_dir(parent: str) -> str:
    (sub,) = [d for d in os.listdir(parent) if os.path.isdir(os.path.join(parent, d))]
    return os.path.join(parent, sub)


def _check_full_benchmark(out_dir: str) -> dict:
    """The smoke config through run_full_benchmark: no row error, the exact
    row at recall 1.0, the four roofline keys on every row (every algorithm
    of the port has a device kernel) and numbers in the summary's TFLOP/s
    and GB/s columns."""
    run_dir = _one_dir(out_dir)
    with open(os.path.join(run_dir, "all_results.json")) as f:
        rows = json.load(f)["random"]
    if "error" in rows:
        raise AssertionError(f"run_full_benchmark: dataset error {rows['error']}")
    for name, row in rows.items():
        if "error" in row:
            raise AssertionError(f"run_full_benchmark/{name}: {row['error']}")
        missing = [k for k in ROOFLINE_KEYS if not row.get(k, 0) > 0]
        if missing:
            raise AssertionError(f"run_full_benchmark/{name}: no {missing}")
    if rows["exact"]["recall"] != 1.0:
        raise AssertionError(f"run_full_benchmark/exact: recall {rows['exact']['recall']}")
    with open(os.path.join(run_dir, "benchmark_summary.md")) as f:
        table = [ln for ln in f.read().splitlines()
                 if ln.startswith("| ") and ln.split("|")[1].strip() in rows]
    for ln in table:
        cells = [c.strip() for c in ln.split("|")[1:-1]]
        if "-" in (cells[6], cells[7]):
            raise AssertionError(f"run_full_benchmark summary: no rate in {ln}")
    if len(table) != len(rows):
        raise AssertionError(f"run_full_benchmark summary: {len(table)} rows of {len(rows)}")
    return {name: {"recall": row["recall"], "qps": row["qps"],
                   **{k: row[k] for k in ROOFLINE_KEYS}} for name, row in rows.items()}


def _check_experiment(name: str, out_dir: str, stdout: str = None) -> dict:
    """main / run_experiment on configs/default.yaml: every row without
    error, exact at recall 1.0; main's per-row lines printed."""
    import yaml

    with open(os.path.join(REPO, "configs", "default.yaml")) as f:
        algos = set(yaml.safe_load(f)["algorithms"])
    (res,) = [f for f in os.listdir(out_dir) if f.endswith("_all_results.json")]
    with open(os.path.join(out_dir, res)) as f:
        rows = json.load(f)
    if set(rows) != algos or any("error" in r for r in rows.values()):
        raise AssertionError(f"{name}: rows {sorted(rows)}, errors "
                             f"{ {k: r.get('error') for k, r in rows.items()} }")
    if rows["exact"]["recall"] != 1.0:
        raise AssertionError(f"{name}: exact recall {rows['exact']['recall']}")
    if stdout is not None:
        printed = {ln.split(":")[0] for ln in stdout.splitlines() if " recall=" in ln}
        if printed != algos:
            raise AssertionError(f"{name}: printed rows {sorted(printed)}")
    return {k: {"recall": r["recall"], "qps": r["qps"]} for k, r in rows.items()}


def _check_sweep(out_dir: str) -> dict:
    for f in ("sweep_results.csv", "sweep_results.json", "sweep_summary.md"):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise AssertionError(f"parameter_sweep: no {f}")
    with open(os.path.join(out_dir, "sweep_results.json")) as f:
        data = json.load(f)
    analysis = data["analysis"]
    if (len(data["rows"]) != 6 or analysis["n_combinations"] != 6
            or set(analysis) != {"best_recall", "best_qps", "balanced", "n_combinations",
                                 "timestamp"}
            or any("error" in r or "recall" not in r for r in data["rows"])):
        raise AssertionError(f"parameter_sweep: {data}")
    return {"combinations": 6, "best_recall": analysis["best_recall"]}


def _check_compare(out_dir: str) -> dict:
    import yaml

    with open(SMOKE_CONFIG) as f:
        algos = sorted(yaml.safe_load(f)["algorithms"])
    for f in ("comparison_stats.json", "comparison_summary.md"):
        if not os.path.exists(os.path.join(out_dir, f)):
            raise AssertionError(f"compare_algorithms: no {f}")
    with open(os.path.join(out_dir, "comparison_stats.json")) as f:
        report = json.load(f)
    stats, sig = report["statistics"], report["significance"]
    pairs = {f"{a}_vs_{b}" for i, a in enumerate(algos) for b in algos[i + 1:]}
    if (report["n_runs"] != 2 or sorted(stats) != algos
            or any(s["recall"]["n"] != 2 for s in stats.values())
            or stats["exact"]["recall"]["mean"] != 1.0 or set(sig) != pairs
            or any(set(t) != {"t_stat", "t_pvalue", "u_stat", "u_pvalue"}
                   for t in sig.values())):
        raise AssertionError(f"compare_algorithms: {report}")
    return {"algorithms": len(algos), "pairs": len(pairs)}


def phase_entry_points(card: str, flagship_phase: dict, exact_row: dict) -> dict:
    """The port's CLIs on the card (no --device): the flagship beside
    phase_throughput's QPS for the same workload, then run_full_benchmark
    on the smoke config, main and run_experiment on configs/default.yaml,
    parameter_sweep on configs/sweep_example.yaml, compare_algorithms on
    the smoke config (2 runs) and run_full_benchmark --create-config, all
    at once; then the counted work of the 100k x 384 exact row against K1's
    formula, and of one exact-search batch on the card against the host."""
    import torch
    import yaml

    from vectordb_retrieval_tpu_torch import flagship
    from vectordb_retrieval_tpu_torch.ops import distances as dops
    from vectordb_retrieval_tpu_torch.ops import kernels
    from vectordb_retrieval_tpu_torch.utils.profiling import cost_estimate

    t0 = time.perf_counter()
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    os.makedirs(ENTRY_DIR)
    out = {name: os.path.join(ENTRY_DIR, name) for name in
           ("full", "main", "experiment", "sweep", "compare")}
    created = os.path.join(ENTRY_DIR, "created.yaml")

    # the flagship alone on the card, then the rest together
    _, stdout, flagship_s = _run_entries({"flagship": ("flagship",)})["flagship"]
    line = json.loads(stdout.strip().splitlines()[-1])
    limit = float(card.split(",")[-1].strip().split()[0])
    if (set(line) != {"metric", "value", "unit", "vs_baseline", "device", "power_limit_w"}
            or line["metric"] != "exact_search_qps_100k_384d_top20"
            or line["device"] != torch.cuda.get_device_name(0)
            or line["power_limit_w"] != limit or not line["value"] > 0):
        raise AssertionError(f"flagship line {line}")
    emit({"phase": "flagship", **line, "nvidia_smi": card, "seconds": flagship_s,
          "phase_throughput_qps": flagship_phase["qps"]})

    default = os.path.join(REPO, "configs", "default.yaml")
    runs = _run_entries({
        "full": ("scripts.run_full_benchmark", "--config", SMOKE_CONFIG,
                 "--output-dir", out["full"]),
        "main": ("main", "--config", default, "--output-dir", out["main"]),
        "experiment": ("scripts.run_experiment", "--config", default,
                       "--output-dir", out["experiment"]),
        "sweep": ("scripts.parameter_sweep", "--config",
                  os.path.join(REPO, "configs", "sweep_example.yaml"),
                  "--output-dir", out["sweep"]),
        "compare": ("scripts.compare_algorithms", "--config", SMOKE_CONFIG, "--runs", "2",
                    "--output-dir", out["compare"]),
        "create_config": ("scripts.run_full_benchmark", "--create-config", created),
    })
    with open(created) as f:
        cfg = yaml.safe_load(f)
    if not {"indexers", "searchers", "algorithms", "datasets"} <= set(cfg):
        raise AssertionError(f"--create-config wrote {sorted(cfg)}")
    checks = {
        "run_full_benchmark": _check_full_benchmark(out["full"]),
        "main": _check_experiment("main", out["main"], runs["main"][1]),
        "run_experiment": _check_experiment("run_experiment", out["experiment"]),
        "parameter_sweep": _check_sweep(out["sweep"]),
        "compare_algorithms": _check_compare(out["compare"]),
        "create_config": sorted(cfg),
    }

    # the exact row (100k x 384, l2, batches of 256) of phase 4: its counted
    # work holds K1 f32's at least; one batch counts alike on card and host
    k1_flops, k1_bytes = kernels.dist_blockmin_work(BATCH, 100_000, 384, 8, torch.float32)
    if not (exact_row["kernel_flops_per_batch"] >= k1_flops
            and exact_row["kernel_bytes_per_batch"] >= k1_bytes):
        raise AssertionError(f"exact row counted work {exact_row} under K1's "
                             f"{k1_flops}, {k1_bytes}")
    dev = torch.device(DEV)
    db, sqn, qs = flagship.make_workload(100_000, 384, 1, BATCH, SEED, dev)
    card_cost = cost_estimate(dops.exact_search, qs[0], db, TOPK, "l2", sqn, device=dev)
    host_cost = cost_estimate(dops.exact_search, qs[0].cpu(), db.cpu(), TOPK, "l2",
                              sqn.cpu(), device="cpu")
    if card_cost != host_cost:
        # K6 counts the distinct blocks its side's stage 2 selected: say
        # where the two sides' selections part before failing
        w = dops.blockmin_width(db.shape[0])
        sel = [dops._blockmin_blocks(q, x, xn, TOPK, "l2", dops.DEFAULT_CHUNK_ROWS, w)[1].cpu()
               for q, x, xn in ((qs[0], db, sqn), (qs[0].cpu(), db.cpu(), sqn.cpu()))]
        differ = (sel[0] != sel[1]).nonzero()
        emit({"phase": "counted_work_mismatch", "card": card_cost, "host": host_cost,
              "distinct_blocks": [int(torch.unique(t).numel()) for t in sel],
              "queries_differing": int((sel[0] != sel[1]).any(1).sum()),
              "ranks_differing": sorted({int(r) for r in differ[:, 1]}), "nb": sel[0].shape[1]})
        raise AssertionError(f"counted work card {card_cost} != host {host_cost}")
    del db, qs, sqn
    torch.cuda.empty_cache()
    result = {
        "phase": "entry_points", "card": card, "checks": checks,
        "seconds_each": {name: r[2] for name, r in runs.items()},
        "exact_row": {k: exact_row[k] for k in ("qps", *ROOFLINE_KEYS)},
        "k1_flops_per_batch": k1_flops, "k1_bytes_per_batch": k1_bytes,
        "exact_batch_counted": card_cost, "seconds": time.perf_counter() - t0,
    }
    emit(result)
    return result


# ---- 7b. calibration ---------------------------------------------------------

CALIB_DIR = os.path.join(OUT_DIR, "calibration")
CALIB_TIMEOUT = 600
# Each tool's recalls must lie within this of the JAX package's own numbers
# for the same run.
CALIB_TOL = 0.03
# scripts/calibrate_glove_surrogate.py's run_setting() at the loader's
# defaults (20k x 50, l2, recall@20), JAX on a host CPU (PERF.md, Calibration)
GLOVE_JAX_DEFAULTS = {"ivf_flat": 0.8708984375, "ivf_pq": 0.917578125,
                      "ivf_sq8": 0.9115234375, "pq": 0.98515625, "hnsw": 0.98515625}
# scripts/calibrate_msmarco_surrogate.py --quick --platform cpu (100k x 384,
# cosine, recall@20), its printed line (PERF.md, Calibration)
MSMARCO_JAX_QUICK = {"ivf_flat": 0.951, "ivf_pq": 0.749, "ivf_sq8": 0.956, "pq": 0.736,
                     "hnsw": 0.985}
# k-means and PQ training draw their rows from a torch.Generator in the port
# and from jax.random in the JAX package: on the manifold corpus those draws
# alone move IVF256,PQ64's recall@20 by up to 0.06. So the manifold points
# and the rotations A/B are held to the JAX package's numbers in a run with
# the JAX package's own draws (jax_permutation in the port's k-means); the
# manifold's nine-point grid also runs as a user runs it, reported. (The
# A/B's own-draws run, reported in PERF.md, would double the phase's
# per-list rotation trainings, which lead its time.)
# scripts/calibrate_manifold.py --platform cpu (100k x 384, l2, recall@20),
# its intrinsic_dim 12 row: (intrinsic_dim, point_scale) -> pq, ivf_pq
# (PERF.md, Calibration)
MANIFOLD_JAX = {(12, 0.35): {"pq": 0.1854, "ivf_pq": 0.5437},
                (12, 0.5): {"pq": 0.1717, "ivf_pq": 0.5619},
                (12, 0.7): {"pq": 0.1852, "ivf_pq": 0.5832}}
# benchmark_results/round5_rotations_ab/rotations_ab.json: regime -> variant
# -> (recall@20, rot_enabled, pq_rot_auto gain); its msmarco_surrogate note
# says "auto OFF", its rows say enabled, and the rows are the gate
ROTATIONS_RECORD = {
    "manifold": {"plain": (0.5604, False, None), "auto": (0.7854, True, 0.6877),
                 "rot128": (0.7777, True, None)},
    "msmarco_surrogate": {"plain": (0.7971, False, None), "auto": (0.8121, True, 0.2769),
                          "rot128": (0.8158, True, None)},
}
ROT_GAIN_TOL = 0.05
# benchmark_results/round5_binary_lsh_tune/recall_frontier.json, num_bits_512:
# multiplier -> recall@20
LSH_FRONTIER = {
    "random": {"64": 0.9596, "128": 0.9910},
    "glove50_surrogate": {"64": 0.9551, "128": 0.9803, "256": 0.9947, "384": 0.9979,
                          "512": 0.9984},
}
# prepare_msmarco's TSVs (rows) and samples
PREP_ROWS = {"corpus": 20_000, "queries": 1_000}
PREP_SAMPLE = {"corpus": 10_000, "queries": 500}
# the kernels this slice's tools launch (K4 and the pair are on no path of it)
CALIB_KERNELS = ("dist_blockmin", "dist_blockmin_bf16", "dist_blockmin_u8", "assign",
                 "slab_dots")


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counters (x1, x2) under the
    key (k1, k2), in uint32 arithmetic: JAX's threefry2x32 primitive."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in rot[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def jax_permutation(n: int, seed: int) -> np.ndarray:
    """``jax.random.permutation(jax.random.PRNGKey(seed), n)`` in NumPy (the
    threefry key of a 32-bit seed, the partitionable split and random bits,
    and JAX's rounds of stable sorts by fresh 32-bit keys); held bit for
    bit against JAX by ``tests/test_torch_calibration.py``."""
    key = (0, int(seed) & 0xFFFFFFFF)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = np.arange(n, dtype=np.int64)
    count, zero = np.arange(n, dtype=np.uint32), np.zeros(n, dtype=np.uint32)
    for _ in range(rounds):
        b1, b2 = _threefry2x32(*key, np.zeros(2, np.uint32), np.arange(2, dtype=np.uint32))
        key, sub = (b1[0], b2[0]), (b1[1], b2[1])
        s1, s2 = _threefry2x32(*sub, zero, count)
        x = x[np.argsort(s1 ^ s2, kind="stable")]
    return x


def jax_uniform(seed: int, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(jax.random.PRNGKey(seed), shape, float32,
    minval, maxval)`` in NumPy: 32 partitionable threefry bits an element
    (the flat index as the counter), 23 of them as a mantissa in [1, 2),
    less 1, scaled and shifted, at least ``minval``."""
    n = int(np.prod(shape))
    b1, b2 = _threefry2x32(0, int(seed) & 0xFFFFFFFF, np.zeros(n, np.uint32),
                           np.arange(n, dtype=np.uint32))
    mant = ((b1 ^ b2) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    lo, hi = np.float32(minval), np.float32(maxval)
    u = mant.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, u * (hi - lo) + lo).reshape(shape)


# XLA's float32 erf_inv (Giles' approximation): coefficients for w < 5 and
# for w >= 5, w = -log1p(-x^2)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def jax_normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)`` in
    NumPy: ``sqrt(2) erf_inv(u)`` of uniforms in (-1, 1), with XLA's f32
    erf_inv; held against JAX within 1e-6 by ``tests/test_torch_probes.py``
    (log1p may differ in the last bit)."""
    x = jax_uniform(seed, shape, np.nextafter(np.float32(-1.0), np.float32(0.0)), 1.0)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, np.float32(c_lt), np.float32(c_ge)) + p * w
    return (np.float32(np.sqrt(2)) * (p * x)).astype(np.float32)


def use_jax_draws() -> None:
    """Make the port draw what the JAX package draws: its k-means rows
    (:func:`jax_permutation`) and its LSH projections and E2LSH offsets
    (:func:`jax_normal`, :func:`jax_uniform`)."""
    import torch

    from vectordb_retrieval_tpu_torch.ops import kmeans
    from vectordb_retrieval_tpu_torch.ops import lsh as lshops

    kmeans._permutation = lambda n, seed: torch.from_numpy(jax_permutation(n, seed))
    lshops.make_projections = lambda seed, t, h, d, device=None: torch.from_numpy(
        jax_normal(seed, (t, d, h))).to(device)
    lshops.make_offsets = lambda seed, t, h, width, device=None: torch.from_numpy(
        jax_uniform(seed ^ 0xE2, (t, h), 0.0, width)).to(device)


def calibration_child(draws: str, module: str, result_path: str, *args: str) -> int:
    """The body of one calibration subprocess: the tool's ``main(args)``
    (no ``--device``: the card) with the launch counts set to 0 just before
    and read just after, under ``capture_launch_inputs``; then every
    captured launch against its plain version. ``draws`` "jax" makes the
    port draw the JAX package's k-means rows and LSH projections
    (:func:`use_jax_draws`), "port" leaves its own. Writes the counts (a
    dist_blockmin_pair launch counts under dist_blockmin_bf16; ``pairs``
    says how many there were), the worst errors and the checked shapes to
    ``result_path``, and the inputs of the last K2 launch on f32 slabs (of
    the layout with fewest slabs), if any, to ``result_path.k2_f32.pt``."""
    import importlib

    import torch

    from vectordb_retrieval_tpu_torch.ops import kernels

    if draws == "jax":
        use_jax_draws()
    tool = importlib.import_module(f"vectordb_retrieval_tpu_torch.scripts.{module}")
    store, pairs = {}, [0]
    kernels.reset_launch_counts()
    with capture_launch_inputs(store, [module], pairs):
        rc = tool.main(list(args))
    launches = dict(kernels.LAUNCHES)
    worst = collections.defaultdict(float)
    shapes = [{"kernel": key[1], "shapes": [list(k) for k in key[2:] if isinstance(k, tuple)],
               "dtypes": [str(a.dtype).split(".")[-1] for a in args if hasattr(a, "dtype")]}
              for key, args in store.items()]
    f32_waves = [args for key, args in store.items()
                 if key[1] == "slab_dots" and args[1].dtype == torch.float32]
    if f32_waves:  # the f32-slab wave of fewest slabs, for the parent to time
        torch.save([a.cpu() for a in min(f32_waves, key=lambda a: a[1].shape[0])],
                    result_path + ".k2_f32.pt")
    check_launched(store, module, worst)
    with open(result_path, "w") as f:
        json.dump({"rc": rc, "launches": launches, "pairs": pairs[0], "worst": worst,
                   "checked": len(shapes), "checked_shapes": shapes}, f)
    return rc


def _write_prep_inputs() -> str:
    """Corpus and query TSVs for prepare_msmarco and its YAML (local TSVs,
    synthetic embed, outputs under CALIB_DIR); returns the YAML's path."""
    import yaml

    raw = os.path.join(CALIB_DIR, "msmarco_raw")
    os.makedirs(raw)
    for name, prefix in (("corpus", "d"), ("queries", "q")):
        with open(os.path.join(raw, f"{name}.tsv"), "w") as f:
            f.writelines(f"{prefix}{i}\ttext number {i}\n" for i in range(PREP_ROWS[name]))
    cfg = {
        "subsample": {"output_dir": os.path.join(CALIB_DIR, "msmarco_subset"),
                      "corpus_sample": PREP_SAMPLE["corpus"],
                      "query_sample": PREP_SAMPLE["queries"], "seed": 42,
                      "corpus_tsv": os.path.join(raw, "corpus.tsv"),
                      "queries_tsv": os.path.join(raw, "queries.tsv")},
        "embed": {"input_dir": os.path.join(CALIB_DIR, "msmarco_subset"),
                  "output_dir": os.path.join(CALIB_DIR, "msmarco_embeddings"),
                  "synthetic": True, "seed": 42},
    }
    path = os.path.join(CALIB_DIR, "prepare_msmarco.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _near(got: dict, want: dict, label: str, failures: list, tol: float = None) -> dict:
    """key -> |got[key] - want[key]| over ``want``'s keys; each over ``tol``
    (default CALIB_TOL) or missing is added to ``failures``."""
    tol = CALIB_TOL if tol is None else tol
    diff = {}
    for key, ref in want.items():
        if key not in got:
            failures.append(f"{label}/{key}: missing")
            continue
        diff[key] = abs(got[key] - ref)
        if diff[key] > tol:
            failures.append(f"{label}/{key}: {got[key]} against {ref}")
    return diff


def _glove_rows(stdout: str) -> dict:
    """setting tag -> recall vector, and the best setting, of the tool's lines."""
    from vectordb_retrieval_tpu_torch.scripts.calibrate_glove_surrogate import TARGETS

    rows = {}
    for ln in stdout.splitlines():
        if "maxerr=" in ln:  # the tag, padded to 46 (longer tags run over), five recalls
            head = ln.rsplit("maxerr=", 1)[0].rstrip()
            tag, values = head[: -len(TARGETS) * 10].strip(), head[-len(TARGETS) * 10:]
            rows[tag] = dict(zip(TARGETS, map(float, values.split())))
    (best,) = [ln for ln in stdout.splitlines() if ln.startswith("best: ")]
    return {"rows": rows, "best": best[len("best: "):]}


def _msmarco_row(stdout: str) -> dict:
    import re

    (ln,) = [ln for ln in stdout.splitlines() if " -> " in ln]
    return {k: float(v) for k, v in re.findall(r"(\w+)=(-?[0-9.]+)\(", ln)}


def phase_calibration(card: str) -> dict:
    """This slice's tools on the card, each in its own subprocess with no
    --device, all at once, at the JAX scripts' full sizes: the GloVe-50
    calibration (five settings, 20k), the MS MARCO one (--quick, 100k), the
    manifold grid (100k) and its gated points with the JAX package's draws,
    the rotations A/B with those draws (100k, both regimes), the
    binary-LSH frontier (random and glove50_surrogate at 512 bits over the
    record's multipliers) and the MS MARCO dataprep pipeline on TSVs written
    here. Each is held to the JAX package's numbers (every gate is read and
    emitted before a failure fails the run); each subprocess holds its
    launches against their plain versions. Returns the launches and the
    worst errors."""
    t0 = time.perf_counter()
    shutil.rmtree(CALIB_DIR, ignore_errors=True)
    os.makedirs(CALIB_DIR)
    prep_cfg = _write_prep_inputs()
    data = {name: os.path.join(CALIB_DIR, f"data_{name}")
            for name in ("manifold", "manifold_jax", "rotations_jax", "lsh_random", "lsh_glove")}
    out = {name: os.path.join(CALIB_DIR, f"{name}.json")
           for name in ("rotations_jax", "lsh_random", "lsh_glove")}
    gated_grid = {"intrinsic_dim": sorted({k[0] for k in MANIFOLD_JAX}),
                  "point_scale": sorted({k[1] for k in MANIFOLD_JAX})}
    # name -> (draws, tool, arguments)
    tools = {
        "glove": ("port", "calibrate_glove_surrogate"),
        "msmarco": ("port", "calibrate_msmarco_surrogate", "--quick"),
        "manifold": ("port", "calibrate_manifold", "--data-dir", data["manifold"]),
        "manifold_jax": ("jax", "calibrate_manifold", "--data-dir", data["manifold_jax"],
                         "--grid", json.dumps(gated_grid)),
        "rotations_jax": ("jax", "exp_manifold_rotations", "--out", out["rotations_jax"],
                          "--data-dir", data["rotations_jax"]),
        "lsh_random": ("port", "exp_binary_lsh_tune", "--dataset", "random", "--num-bits",
                       "512", "--mults", ",".join(LSH_FRONTIER["random"]), "--out",
                       out["lsh_random"], "--data-dir", data["lsh_random"]),
        "lsh_glove": ("port", "exp_binary_lsh_tune", "--dataset", "glove50_surrogate",
                      "--num-bits", "512", "--mults", ",".join(LSH_FRONTIER["glove50_surrogate"]),
                      "--out", out["lsh_glove"], "--data-dir", data["lsh_glove"]),
        "prepare_msmarco": ("port", "prepare_msmarco", "--config", prep_cfg),
    }
    child = "import sys, chip_smoke; sys.exit(chip_smoke.calibration_child(*sys.argv[1:]))"
    runs = _run_procs(
        {name: [sys.executable, "-c", child, draws, module,
                os.path.join(CALIB_DIR, f"{name}.result.json"), *args]
         for name, (draws, module, *args) in tools.items()},
        CALIB_DIR, CALIB_TIMEOUT)
    results = {}
    for name in tools:
        with open(os.path.join(CALIB_DIR, f"{name}.result.json")) as f:
            results[name] = json.load(f)
    lines = {}

    def line(name, **kw):
        res = results[name]
        lines[name] = {"phase": "calibration", "tool": tools[name][1], "draws": tools[name][0],
                       "card": card, "seconds": runs[name][2], "launches": res["launches"],
                       "launches_checked": res["checked"], "worst": res["worst"], **kw}

    failures = []
    glove = _glove_rows(runs["glove"][1])
    if len(glove["rows"]) != 5:
        failures.append(f"glove: {len(glove['rows'])} settings of 5")
    defaults = glove["rows"].get("(defaults)", {})
    line("glove", defaults=defaults, jax_defaults=GLOVE_JAX_DEFAULTS,
         diff=_near(defaults, GLOVE_JAX_DEFAULTS, "glove", failures),
         settings=glove["rows"], best=glove["best"])

    msm = _msmarco_row(runs["msmarco"][1])
    line("msmarco", recalls=msm, jax_quick=MSMARCO_JAX_QUICK,
         diff=_near(msm, MSMARCO_JAX_QUICK, "msmarco", failures))

    def points(name):
        return [json.loads(ln) for ln in runs[name][1].splitlines() if ln.startswith('{"opts"')]

    def key(p):
        return (p["opts"]["intrinsic_dim"], p["opts"]["point_scale"])

    own = points("manifold")
    if len(own) != 9:
        failures.append(f"manifold: {len(own)} points of the default grid's 9")
    line("manifold", points=own)
    gated = {}
    for p in points("manifold_jax"):
        label = f"manifold_jax/{key(p)[0]}/{key(p)[1]}"
        gated[label] = _near(p, MANIFOLD_JAX[key(p)], label, failures)
    if len(gated) != len(MANIFOLD_JAX):
        failures.append(f"manifold_jax: gated points {sorted(gated)}")
    line("manifold_jax", points=points("manifold_jax"),
         jax=[{"intrinsic_dim": k[0], "point_scale": k[1], **v} for k, v in MANIFOLD_JAX.items()],
         diff=gated)

    with open(out["rotations_jax"]) as f:
        doc = json.load(f)
    rot_diff = {}
    for regime, variants in ROTATIONS_RECORD.items():
        rows = doc["regimes"][regime]["rows"]
        for variant, (recall, enabled, gain) in variants.items():
            row, label = rows[variant], f"rotations_jax/{regime}/{variant}"
            if row["rot_enabled"] != enabled:
                failures.append(f"{label}: rot_enabled {row['rot_enabled']}")
            rot_diff[label] = _near(row, {"recall": recall}, label, failures)["recall"]
            if gain is not None:
                if row["pq_rot_auto"]["enabled"] != enabled:
                    failures.append(f"{label}: auto enabled {row['pq_rot_auto']['enabled']}")
                rot_diff[f"{label}/gain"] = _near(row["pq_rot_auto"], {"gain": gain}, label,
                                                  failures, ROT_GAIN_TOL)["gain"]
    line("rotations_jax", regimes=doc["regimes"], record=ROTATIONS_RECORD, diff=rot_diff)

    for name, dataset in (("lsh_random", "random"), ("lsh_glove", "glove50_surrogate")):
        with open(out[name]) as f:
            rows = json.load(f)["rows"]
        got = {m: r["recall"] for m, r in rows.items()}
        line(name, dataset=dataset, num_bits=512, rows=rows, record=LSH_FRONTIER[dataset],
             diff=_near(got, LSH_FRONTIER[dataset], name, failures))

    emb = os.path.join(CALIB_DIR, "msmarco_embeddings")
    shapes = {f: list(np.load(os.path.join(emb, f"{f}.npy")).shape)
              for f in ("passage_embeddings", "query_embeddings", "passage_ids", "query_ids")}
    want_shapes = {"passage_embeddings": [PREP_SAMPLE["corpus"], 384],
                   "query_embeddings": [PREP_SAMPLE["queries"], 384],
                   "passage_ids": [PREP_SAMPLE["corpus"]], "query_ids": [PREP_SAMPLE["queries"]]}
    if shapes != want_shapes:
        failures.append(f"prepare_msmarco wrote {shapes}, not {want_shapes}")
    line("prepare_msmarco", shapes=shapes)

    launches = {name: sum(r["launches"][name] for r in results.values())
                for name in results["glove"]["launches"]}
    missing = [name for name in CALIB_KERNELS if launches[name] < 1]
    if missing:
        failures.append(f"never launched {missing}")
    worst = collections.defaultdict(float)
    for r in results.values():
        for name, err in r["worst"].items():
            worst[name] = max(worst[name], err)
    for name in tools:
        emit(lines[name])
    seconds = time.perf_counter() - t0
    emit({"phase": "calibration_run", "card": card, "seconds": seconds,
          "within_180_s": seconds <= 180.0, "launches": launches, "worst": worst,
          "tools": {name: runs[name][2] for name in tools}, "failures": failures})
    for name in data.values():
        shutil.rmtree(name, ignore_errors=True)
    if failures:
        raise AssertionError(f"calibration: {failures}")
    return {"launches": launches, "worst": worst}


# ---- 7c. research probes --------------------------------------------------

PROBE_DIR = os.path.join(OUT_DIR, "probes")
PROBE_TIMEOUT = 600
# benchmark_results/round3_lsh_frontier/frontier_sift1m_tpu.log (the JAX
# package on a TPU, the SIFT1M surrogate, 256 queries; README.md's table
# rounds it): the median kth-NN angle and l2 distance, and (metric, tables,
# bits, multiplier) -> recall@100
LSH_RECORD_THETA, LSH_THETA_TOL = 38.4, 0.5
LSH_RECORD_R, LSH_R_REL = 337.9, 0.01
LSH_RECORD = {
    ("cosine", 2, 18, 4.0): 0.0218, ("cosine", 4, 16, 4.0): 0.0298,
    ("cosine", 8, 16, 8.0): 0.0579, ("cosine", 8, 14, 8.0): 0.0646,
    ("cosine", 12, 14, 16.0): 0.1154, ("cosine", 12, 12, 16.0): 0.1607,
    ("cosine", 16, 12, 32.0): 0.2523, ("cosine", 24, 10, 32.0): 0.4452,
    ("cosine", 32, 8, 64.0): 0.6702, ("l2", 4, 6, 8.0): 0.009, ("l2", 8, 6, 16.0): 0.0152,
    ("l2", 8, 8, 16.0): 0.0442, ("l2", 12, 8, 32.0): 0.085,
}
# benchmark_results/round5_covertree_hard/ab.json: both walks exact
COVERTREE_HARD_DESCENTS = ("blockwalk", "stream")
# exp_covertree_hard's --n default: the probe's corpus rows
COVERTREE_HARD_ROWS = 100_000
# models/graph.py:76-84 (the JAX package's exp_glove_geometry.py sweep):
# recall@20 at ef 125, iters 4, by reverse_edges (2M, M)
GLOVE_GEOMETRY_RECORD = {32: 0.9840, 16: 0.9727}
# exp_glove_geometry.py:3-5: rev = M at saturation (ef 512, iters 12), and
# no row left unreachable
GLOVE_SATURATION_RECORD = 0.995
# the kernels the probes launch (K4 is on no path)
PROBE_KERNELS = ("dist_blockmin", "dist_blockmin_bf16", "dist_blockmin_u8", PAIR, "assign",
                 "slab_dots")


def _lsh_frontier_rows(stdout: str) -> dict:
    """The difficulty line's angle and distance, and the rows by setting."""
    import re

    (head,) = [ln for ln in stdout.splitlines() if ln.startswith("corpus ")]
    theta, r = map(float, re.search(r"angle=([0-9.]+)deg l2 r=([0-9.]+)", head).groups())
    rows = {}
    for ln in stdout.splitlines():
        row = json.loads(ln) if ln.startswith('{"metric"') else None
        if row is not None:
            rows[(row["metric"], row["num_tables"], row["hash_size"],
                  row["candidate_multiplier"])] = row
    return {"theta": theta, "r": r, "rows": rows}


def _lsh_frontier_gate(name: str, got: dict, failures: list) -> dict:
    """The difficulty and every row's recall@100 against the record."""
    if abs(got["theta"] - LSH_RECORD_THETA) > LSH_THETA_TOL:
        failures.append(f"{name}/theta: {got['theta']} against {LSH_RECORD_THETA}")
    if abs(got["r"] - LSH_RECORD_R) > LSH_R_REL * LSH_RECORD_R:
        failures.append(f"{name}/r: {got['r']} against {LSH_RECORD_R}")
    recalls = {"/".join(map(str, key)): row["recall"] for key, row in got["rows"].items()}
    record = {"/".join(map(str, key)): v for key, v in LSH_RECORD.items()}
    return _near(recalls, record, name, failures)


def _glove_ceiling_rows(stdout: str) -> dict:
    """reverse_edges -> in-degree-0 count and the two recalls."""
    import re

    rows = {}
    for ln in stdout.splitlines():
        m = re.match(r"rev=(2?M) .*in-deg-0=\s*(\d+)  recall\(ef125,it3\)=([0-9.]+)"
                     r"  recall\(ef512,it12\)=([0-9.]+)$", ln)
        if m:
            rev = 32 if m.group(1) == "2M" else 16
            rows[rev] = {"in_deg_0": int(m.group(2)), "ef125_it3": float(m.group(3)),
                         "ef512_it12": float(m.group(4))}
    return rows


def _glove_geometry_rows(stdout: str) -> dict:
    """(reverse_edges, ef, iters) -> recall, rows a query and wall seconds."""
    import re

    rows = {}
    for ln in stdout.splitlines():
        m = re.match(r"rev=\s*(\d+) ef=\s*(\d+) it=(\d+)  recall=([0-9.]+)  rows/q~\s*(\d+)"
                     r"  wall=\s*([0-9.]+)s$", ln)
        if m:
            rev, ef, it = map(int, m.groups()[:3])
            rows[(rev, ef, it)] = {"recall": float(m.group(4)), "rows_q": int(m.group(5)),
                                   "wall_s": float(m.group(6))}
    return rows


def _block_geometry_rows(stdout: str) -> list:
    import re

    rows = []
    for ln in stdout.splitlines():
        if ln.startswith("block="):
            rows.append({k: (float(v) if "." in v else int(v)) if k != "slab" else v
                         for k, v in re.findall(r"(\w+)=(\S+)", ln)})
    return rows


def _covertree_hard_ties(data_dir: str, b: int, k: int) -> dict:
    """The float32 ties at rank ``k`` of exp_covertree_hard's queries, from
    its cached corpus and float64 cosines on the card. The walks score
    cosine as the difference form over normalised rows, the ground truth
    (exact search) as a negated dot product, each an f32 sum in its own
    order: the rows within ``F32_TIE_REL`` (of a cosine's scale, 1) of a
    query's k-th cosine form its boundary band, and a band of m rows lets
    an exact float32 answer miss m - 1 of the ground truth's."""
    import torch

    from vectordb_retrieval_tpu_torch.data.datasets import Dataset
    from vectordb_retrieval_tpu_torch.scripts.probes import F32_TIE_REL

    ds = Dataset("msmarco_surrogate", data_dir=data_dir, device=DEV, options={
        "train_limit": COVERTREE_HARD_ROWS, "test_size": b, "ground_truth_k": k}).load()
    x = torch.as_tensor(np.asarray(ds.train_vectors), device=DEV, dtype=torch.float64)
    q = torch.as_tensor(np.asarray(ds.test_vectors[:b]), device=DEV, dtype=torch.float64)
    s = (q / q.norm(dim=1, keepdim=True)) @ (x / x.norm(dim=1, keepdim=True)).T
    kth = s.topk(k, dim=1).values[:, -1:]
    band = ((s - kth).abs() <= F32_TIE_REL).sum(dim=1) - 1
    del x, s
    torch.cuda.empty_cache()
    return {"pairs": b * k, "swappable": int(band.sum()),
            "queries_tied": int((band > 0).sum()), "tol": F32_TIE_REL}


def phase_probes(card: str) -> dict:
    """The research probes on the card, each in its own subprocess with no
    --device, all at once, at the JAX scripts' full sizes: the LSH
    guarantee frontier (the SIFT1M surrogate, 1M x 128, 256 queries,
    top-100, 13 settings) with the port's own projections and again with
    the JAX package's draws (gated), the cover-tree hard A/B (msmarco
    surrogate 100k x 384, both walks), the GloVe-50 reachability probe and
    its 18-point geometry sweep (20k x 50), the block-graph geometry sweep
    (100k x 384, three spills, six geometries, f32 slabs) and the manifold
    structure probe (100k x 384, four rows). Gates: the frontier's
    difficulty and recalls against the JAX package's record, both walks
    present and exact (a miss only where float32 ties at rank k allow it:
    ``_covertree_hard_ties``), the GloVe in-degree-0 counts and recalls against the
    numbers the JAX package's defaults cite; the block sweep and the
    manifold rows are recorded. Every gate is read and emitted before a
    failure fails the run; each subprocess holds its launches against
    their plain versions. Returns the launches and the worst errors."""
    t0 = time.perf_counter()
    shutil.rmtree(PROBE_DIR, ignore_errors=True)
    os.makedirs(PROBE_DIR)
    data = {name: os.path.join(PROBE_DIR, f"data_{name}")
            for name in ("covertree", "glove_ceiling", "glove_geometry", "block")}
    ab_json = os.path.join(PROBE_DIR, "covertree_hard.json")
    # name -> (draws, probe, arguments); the frontier reads OUT_DIR/sift1m_synth
    probes = {
        "lsh_frontier": ("port", "exp_lsh_frontier", "--data-dir", OUT_DIR),
        "lsh_frontier_jax": ("jax", "exp_lsh_frontier", "--data-dir", OUT_DIR),
        "covertree_hard": ("port", "exp_covertree_hard", "--out", ab_json,
                           "--data-dir", data["covertree"]),
        "glove_ceiling": ("port", "exp_glove_ceiling", "--data-dir", data["glove_ceiling"]),
        "glove_geometry": ("port", "exp_glove_geometry", "--data-dir", data["glove_geometry"]),
        "block_geometry": ("port", "exp_block_geometry", "--data-dir", data["block"]),
        "manifold_structure": ("port", "exp_manifold_structure"),
    }
    child = "import sys, chip_smoke; sys.exit(chip_smoke.calibration_child(*sys.argv[1:]))"
    runs = _run_procs(
        {name: [sys.executable, "-c", child, draws, module,
                os.path.join(PROBE_DIR, f"{name}.result.json"), *args]
         for name, (draws, module, *args) in probes.items()},
        PROBE_DIR, PROBE_TIMEOUT)
    results = {}
    for name in probes:
        with open(os.path.join(PROBE_DIR, f"{name}.result.json")) as f:
            results[name] = json.load(f)
    lines = {}

    def line(name, **kw):
        res = results[name]
        lines[name] = {"phase": "probes", "probe": probes[name][1], "draws": probes[name][0],
                       "card": card, "seconds": runs[name][2], "launches": res["launches"],
                       "pairs": res["pairs"], "launches_checked": res["checked"],
                       "worst": res["worst"], **kw}

    failures = []
    for name in ("lsh_frontier", "lsh_frontier_jax"):
        got = _lsh_frontier_rows(runs[name][1])
        sink = failures if name == "lsh_frontier_jax" else []
        diff = _lsh_frontier_gate(name, got, sink)
        line(name, gated=name == "lsh_frontier_jax", theta_deg=got["theta"], r=got["r"],
             rows=list(got["rows"].values()), misses=sink, diff=diff)
        if len(got["rows"]) != len(LSH_RECORD):
            failures.append(f"{name}: {len(got['rows'])} rows of {len(LSH_RECORD)}")

    stdout = runs["covertree_hard"][1]
    with open(ab_json) as f:
        ab = json.load(f)
    ties = None
    for descent in COVERTREE_HARD_DESCENTS:
        row = ab["rows"].get(descent)
        if row is None or f"{descent}: FAILED" in stdout:
            failures.append(f"covertree_hard/{descent}: no row")
        elif row["recall"] != 1.0:
            # a miss is exact only where float32 ties at rank k allow it
            if ties is None:
                ties = _covertree_hard_ties(data["covertree"], ab["b"], ab["k"])
            misses = round((1.0 - row["recall"]) * ties["pairs"])
            if misses > ties["swappable"]:
                failures.append(f"covertree_hard/{descent}: recall {row['recall']}, "
                                f"{misses} misses beyond {ties['swappable']} tied rows")
    line("covertree_hard", build=stdout.splitlines()[0], ties=ties, **ab)

    ceiling = _glove_ceiling_rows(runs["glove_ceiling"][1])
    for rev in (16, 32):
        if ceiling.get(rev, {}).get("in_deg_0") != 0:
            failures.append(f"glove_ceiling/rev={rev}: {ceiling.get(rev)}")
    sat = _near({"ef512_it12": ceiling.get(16, {}).get("ef512_it12", -1.0)},
                {"ef512_it12": GLOVE_SATURATION_RECORD}, "glove_ceiling/rev=16", failures)
    line("glove_ceiling", rows=ceiling, record_saturation=GLOVE_SATURATION_RECORD, diff=sat)

    geometry = _glove_geometry_rows(runs["glove_geometry"][1])
    if len(geometry) != 18:
        failures.append(f"glove_geometry: {len(geometry)} points of 18")
    at = {rev: geometry.get((rev, 125, 4), {}).get("recall", -1.0) for rev in (32, 16)}
    line("glove_geometry", points=[{"rev": k[0], "ef": k[1], "iters": k[2], **v}
                                   for k, v in geometry.items()],
         record_ef125_it4=GLOVE_GEOMETRY_RECORD,
         diff=_near(at, GLOVE_GEOMETRY_RECORD, "glove_geometry/ef125_it4", failures))

    block = _block_geometry_rows(runs["block_geometry"][1])
    if len(block) != 3 * 6:
        failures.append(f"block_geometry: {len(block)} points of 18")
    line("block_geometry", points=block,
         builds=[ln for ln in runs["block_geometry"][1].splitlines() if ln.startswith("built ")])

    (manifold,) = [json.loads(ln) for ln in runs["manifold_structure"][1].splitlines()
                   if ln.startswith('{"args"')]
    if list(manifold["rows"]) != ["pq64", "ivf_pq", "ivf_sq8", "ivf_flat"]:
        failures.append(f"manifold_structure: rows {list(manifold['rows'])}")
    line("manifold_structure", rows=manifold["rows"])

    launches = collections.Counter()
    for r in results.values():
        launches.update(r["launches"])
        launches[PAIR] += r["pairs"]
        launches["dist_blockmin_bf16"] -= r["pairs"]
    missing = [name for name in PROBE_KERNELS if launches[name] < 1]
    if missing:
        failures.append(f"never launched {missing}")
    # the block sweep's K2 f32 waves at L = 256, d = 384, held to the plain version
    k2_f32 = [c["shapes"] for c in results["block_geometry"]["checked_shapes"]
              if c["kernel"] == "slab_dots" and c["dtypes"][1] == "float32"
              and c["shapes"][1][1:] == [256, 384]]
    if not k2_f32:
        failures.append("block_geometry: no K2 f32 launch at L = 256, d = 384 checked")
    k2 = None
    wave = os.path.join(PROBE_DIR, "block_geometry.result.json.k2_f32.pt")
    if os.path.exists(wave):  # one real f32 wave, timed here beside its yardsticks
        import torch

        k2 = _slab_dots_numbers(*(a.to(DEV) for a in torch.load(wave)))
        k2.update({"config": "exp_block_geometry", "row": "spill 0, f32 slabs",
                   "launches": results["block_geometry"]["launches"]["slab_dots"]})
        emit({"phase": "probes_k2_f32", "card": card, **k2})
    worst = collections.defaultdict(float)
    for r in results.values():
        for name, err in r["worst"].items():
            worst[name] = max(worst[name], err)
    for name in probes:
        emit(lines[name])
    seconds = time.perf_counter() - t0
    emit({"phase": "probes_run", "card": card, "seconds": seconds, "launches": dict(launches),
          "worst": worst, "probes": {name: runs[name][2] for name in probes},
          "k2_f32_l256_d384_checked": k2_f32, "failures": failures})
    for name in data.values():
        shutil.rmtree(name, ignore_errors=True)
    if failures:
        raise AssertionError(f"probes: {failures}")
    return {"launches": dict(launches), "worst": worst, "k2_f32": k2}


# ---- 7d. tuning probes ---------------------------------------------------

TUNING_DIR = os.path.join(OUT_DIR, "tuning")
TUNING_TIMEOUT = 900  # seconds for the phase's one subprocess
# (probe, arguments), in the order they run; the SIFT surrogate's probes read
# OUT_DIR/sift1m_synth (phase 2)
TUNING_PROBES = (
    ("exp_blockmin_width", ()),
    ("exp_flagship_w", ()),
    ("exp_flagship_sweep", ()),
    ("exp_flagship_batch", ()),
    ("exp_flagship_profile", ()),
    ("exp_blockmin_stages", ()),
    ("exp_topk_twolevel", ()),
    ("exp_ivf_fused_profile", ("--data-dir", OUT_DIR)),
    ("exp_ivf_tail", ()),
    ("exp_block_rescore", ()),
    ("exp_covertree_blockwalk", ("--data-dir", OUT_DIR)),
    ("exp_covertree_profile", ("--data-dir", os.path.join(TUNING_DIR, "data"))),
    ("exp_covertree_stream_profile", ()),
    ("exp_covertree_iter_cost", ()),
    ("exp_dbm_tune", ()),
    ("exp_dbm_tune", ("--n", "1000000", "--d", "128", "--w", "32")),
    ("exp_dist_blockmin", ()),
    ("exp_slab_rescore", ()),
    ("exp_dbm_flagship", ()),
    ("exp_slab_ring", ()),
    ("exp_flagship_unroll", ()),
    ("exp_beam_profile", ()),
    ("exp_beam_ablate", ()),
    ("exp_beam_tune", ()),
    ("exp_beam_table_tune", ()),
    ("exp_graph_neighbor_table", ()),
    ("exp_topk_cost", ()),
    ("exp_topk_cost2", ()),
)
# the graph probes read recall: they run with the JAX package's k-means draws
TUNING_JAX_DRAWS = ("exp_beam_ablate", "exp_beam_tune", "exp_beam_table_tune",
                    "exp_graph_neighbor_table")
# the IVF rescore's two tails (block gather, K2) agree on each query's
# nearest distance to f32 rounding of a 128-term sum
TAIL_REL_TOL = 1e-5
# the f32 rounding of a 128-term difference sum against float64 (the port
# and the JAX package on a host CPU: 7.0e-8)
RESCORE_REL_TOL = 1e-6
# the cover tree's difference from the exact scan, relative to the largest
# exact distance: the walk rescores in difference form, the scan refines
WALK_REL_TOL = 1e-3
SELECT_REL_TOL = 1e-6
SWEEP_MIN_AGREE = 0.999
TUNING_KERNELS = ("dist_blockmin", "dist_blockmin_bf16", PAIR, "assign", "slab_dots",
                  "matmul_floor")


def _gate_blockmin_width(c):
    return [f"{shape}/w={w}: rel err {r['rel_err']}, ids {r['ids_agree']}"
            for shape, rows in c["shapes"].items() for w, r in rows.items()
            if r["rel_err"] > KERNEL_REL_TOL or r["ids_agree"] < 1.0]


def _gate_values(values, ok, what):
    return [f"{key}: {what} {v}" for key, v in values.items() if not ok(v)]


def _gate_beam_recall(c):
    """The graph probes' best recall@20 against the JAX scripts' own pass
    line (BASELINE.md's FAISS CPU hnsw row on random-20k)."""
    from vectordb_retrieval_tpu_torch.scripts.probes import BEAM_PASS_RECALL

    return _gate_values({"best": c["best_recall"]}, lambda v: v >= BEAM_PASS_RECALL, "recall")


# probe -> the failures of its check line (one gate a probe)
TUNING_GATES = {
    "exp_blockmin_width": _gate_blockmin_width,
    "exp_flagship_w": lambda c: _gate_values(
        {k: r["recall"] for k, r in c["rows"].items()}, lambda v: v == 1.0, "recall"),
    "exp_flagship_sweep": lambda c: _gate_values(
        {f"reps={r}/w={w}": v for r, ws in c["agree"].items() for w, v in ws.items()},
        lambda v: v >= SWEEP_MIN_AGREE, "ids agree"),
    "exp_flagship_batch": lambda c: _gate_values(
        {f"{i}/batch={r['batch']}": r["share"] for i, r in enumerate(c["ids_agree"])},
        lambda v: v == 1.0, "ids agree"),
    "exp_flagship_profile": lambda c: _gate_values(
        {"a": c["a_ids_agree"]}, lambda v: v == 1.0, "ids agree"),
    "exp_blockmin_stages": lambda c: _gate_values(
        {"stage3": c["stage3_ids_agree"]}, lambda v: v == 1.0, "ids agree"),
    "exp_topk_twolevel": lambda c: _gate_values(
        {g: c["two_level_equal"][g] for g in ("8", "16", "32")}, bool, "equal"),
    "exp_ivf_fused_profile": lambda c: _gate_values(
        {"stage 5": c["full_ids_equal"]}, bool, "ids equal"),
    "exp_ivf_tail": lambda c: _gate_values(
        {k: c[k] for k in ("b_equals_c", "e_equals_f")}, bool, "equal"),
    "exp_block_rescore": lambda c: _gate_values(
        {"a.diff-sum": c["max_rel_err"]["a.diff-sum"]}, lambda v: v <= RESCORE_REL_TOL,
        "max rel err"),
    "exp_covertree_blockwalk": lambda c: _gate_values(
        {w: c["walks"].get(w, {}).get("recall", -1.0) for w in ("blockwalk", "stream")},
        lambda v: v == 1.0, "recall"),
    "exp_covertree_profile": lambda c: _gate_values(
        {"stream walk": c["recall"]}, lambda v: v == 1.0, "recall") + _gate_values(
        {"stream walk": c["max_rel_diff"]}, lambda v: v <= WALK_REL_TOL, "max rel diff"),
    "exp_covertree_stream_profile": lambda c: _gate_values(
        c["rel_diff_to_fullwidth"], lambda v: v <= SELECT_REL_TOL, "rel diff"),
    "exp_covertree_iter_cost": lambda c: _gate_values(
        {"checksums": c["finite_in_range"]}, bool, "finite, in range"),
    "exp_dbm_tune": lambda c: _gate_values(
        {"floor": c["floor_rel_err"]}, lambda v: v <= KERNEL_REL_TOL, "rel err") + _gate_values(
        {"floor": c["floor_finite"]}, bool, "finite"),
    "exp_dist_blockmin": lambda c: _gate_values(
        c["agreement"], lambda v: v == 1.0, "distance agreement"),
    "exp_slab_rescore": lambda c: _gate_values(
        {"slab dots": c["slab_max_abs_err"]}, lambda v: v <= c["slab_tol"],
        "max abs err") + _gate_values(
        {"first distances": c["first_rel_diff"]}, lambda v: v <= TAIL_REL_TOL, "rel diff"),
    "exp_dbm_flagship": lambda c: _gate_values({"outputs": c["finite"]}, bool, "finite"),
    "exp_slab_ring": lambda c: _gate_values(
        {k: r["max_abs_err"] / max(r["max_abs_plain"], 1e-30) for k, r in c["shapes"].items()},
        lambda v: v <= KERNEL_REL_TOL, "rel err"),
    "exp_flagship_unroll": lambda c: _gate_values(
        {k: r["ids_agree"] for k, r in c["rows"].items()}, lambda v: v == 1.0, "ids agree"),
    "exp_beam_profile": lambda c: _gate_values(
        {"checksums": c["finite"], "ids": c["ids_in_range"]}, bool, "finite, in range"),
    "exp_beam_ablate": lambda c: _gate_values(
        {"ids": c["ids_equal"], "distances": c["dists_equal"]}, bool,
        "equal to graph_search's"),
    "exp_beam_tune": _gate_beam_recall,
    "exp_beam_table_tune": _gate_beam_recall,
    "exp_graph_neighbor_table": _gate_beam_recall,
    "exp_topk_cost": lambda c: _gate_values(
        {**c["topk_equals_sort"], **c["rank_merge_equals_sort"]}, bool, "equal to a sort"),
    "exp_topk_cost2": lambda c: _gate_values({"outputs": c["finite"]}, bool, "finite") + [
        f"dedup {k}: {v['counted']} != numpy {v['numpy']}"
        for k, v in c["dedup_counts"].items() if v["counted"] != v["numpy"]],
}


def tuning_child(plan_path: str) -> int:
    """The body of phase 7d's one subprocess: the plan's runs ``(name,
    draws, module, result_path, args)`` one after another, each through
    :func:`calibration_child` with its output in ``<name>.out`` / ``.err``
    and ``{"rc", "seconds"}`` in ``<name>.status.json``, so one process start
    serves every probe. Each run starts from the port's own draws (a
    "jax" run's patches are undone after it) and from a drained card: the
    stream synchronised, the allocator's cache emptied and its peak reset.
    A run that raises is recorded and the next one runs; an error that
    leaves the CUDA context unusable (the synchronise after a run raises)
    stops the plan there, and every later run is recorded as not run,
    naming the run at fault, not as a fault of its own."""
    import contextlib
    import traceback

    import torch

    from vectordb_retrieval_tpu_torch.ops import kmeans
    from vectordb_retrieval_tpu_torch.ops import lsh as lshops

    own = (kmeans._permutation, lshops.make_projections, lshops.make_offsets)
    with open(plan_path) as f:
        plan = json.load(f)
    fault = None
    for name, draws, module, result, args in plan:
        if fault is not None:
            with open(f"{name}.err", "w") as f:
                f.write(f"not run: the CUDA context failed in {fault}\n")
            with open(f"{name}.status.json", "w") as f:
                json.dump({"rc": 1, "seconds": 0.0, "after_fault_in": fault}, f)
            continue
        kmeans._permutation, lshops.make_projections, lshops.make_offsets = own
        t0 = time.perf_counter()
        with open(f"{name}.out", "w") as out, open(f"{name}.err", "w") as err, \
                contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = calibration_child(draws, module, result, *args)
            except Exception:  # recorded; the next probe still runs
                traceback.print_exc()
                rc = 1
            seconds = time.perf_counter() - t0
            try:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            except RuntimeError:  # a sticky CUDA error: no later run can use the card
                traceback.print_exc()
                fault, rc = name, rc or 1
        with open(f"{name}.status.json", "w") as f:
            json.dump({"rc": rc, "seconds": seconds}, f)
    return 0


def _tuning_check(stdout: str):
    """``(the probe's printed lines, the check's numbers)``: the check line
    and the child's own kernel-check lines apart."""
    lines = stdout.splitlines()
    checks = [json.loads(ln[len("check "):]) for ln in lines if ln.startswith("check ")]
    rows = [ln for ln in lines if not ln.startswith(("check ", '{"phase": '))]
    return rows, (checks or [None])[-1]


def phase_tuning(card: str) -> dict:
    """The tuning probes on the card, one at a time in one subprocess
    (:func:`tuning_child`) with no --device (each through
    ``calibration_child``: launch counts set to 0 before, every captured
    launch held to its plain version after), at the JAX scripts' default
    sizes (``exp_dbm_tune`` also at 1M x 128, w 32; the graph probes of
    TUNING_JAX_DRAWS with the JAX package's k-means draws). Each probe's
    lines and its check go to one line with the card; a probe that raises
    or misses its gate is a failure, read and emitted for every run before
    the run fails. Returns the launches and the worst errors."""
    t0 = time.perf_counter()
    shutil.rmtree(TUNING_DIR, ignore_errors=True)
    os.makedirs(TUNING_DIR)
    launches = collections.Counter()
    worst = collections.defaultdict(float)
    failures, seconds, plan = [], {}, []
    runs = collections.Counter()
    for module, args in TUNING_PROBES:
        runs[module] += 1  # a probe run twice: its second run's files apart
        name = module if runs[module] == 1 else f"{module}_{runs[module]}"
        draws = "jax" if module in TUNING_JAX_DRAWS else "port"
        plan.append((name, draws, module, os.path.join(TUNING_DIR, f"{name}.result.json"),
                     list(args)))
    plan_path = os.path.join(TUNING_DIR, "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    child = "import sys, chip_smoke; sys.exit(chip_smoke.tuning_child(sys.argv[1]))"
    try:
        _run_procs({"tuning": [sys.executable, "-c", child, plan_path]}, TUNING_DIR,
                   TUNING_TIMEOUT)
    except AssertionError as e:
        failures.append(f"the phase's subprocess did not finish: {str(e)[-2000:]}")
    for name, draws, module, result, args in plan:
        probe_failures, stdout, res = [], "", None
        try:
            with open(os.path.join(TUNING_DIR, f"{name}.status.json")) as f:
                status = json.load(f)
            seconds[name] = status["seconds"]
            with open(os.path.join(TUNING_DIR, f"{name}.out")) as f:
                stdout = f.read()
            if status["rc"] != 0:
                with open(os.path.join(TUNING_DIR, f"{name}.err")) as f:
                    raise AssertionError(f"exited {status['rc']}:\n{f.read()[-2000:]}")
            with open(result) as f:
                res = json.load(f)
        except (AssertionError, OSError) as e:
            probe_failures.append(f"did not finish: {str(e)[-2000:]}")
        rows, check = _tuning_check(stdout)
        if res is not None:
            if check is None:
                probe_failures.append("no check line")
            else:
                probe_failures += TUNING_GATES[module](check)
            launches.update(res["launches"])
            launches[PAIR] += res["pairs"]
            launches["dist_blockmin_bf16"] -= res["pairs"]
            for kernel, err in res["worst"].items():
                worst[kernel] = max(worst[kernel], err)
        failures += [f"{name}: {f}" for f in probe_failures]
        emit({"phase": "tuning_probes", "probe": module, "args": list(args), "card": card,
              "draws": draws, "seconds": seconds.get(name), "rows": rows, "check": check,
              "launches": None if res is None else res["launches"],
              "pairs": None if res is None else res["pairs"],
              "launches_checked": None if res is None else res["checked"],
              "worst": None if res is None else res["worst"], "failures": probe_failures})
    missing = [name for name in TUNING_KERNELS if launches[name] < 1]
    if missing:
        failures.append(f"never launched {missing}")
    emit({"phase": "tuning_probes_run", "card": card, "seconds": time.perf_counter() - t0,
          "probes": seconds, "launches": dict(launches), "worst": worst, "failures": failures})
    shutil.rmtree(os.path.join(TUNING_DIR, "data"), ignore_errors=True)
    if failures:
        raise AssertionError(f"tuning probes: {failures}")
    return {"launches": dict(launches), "worst": worst}


def main() -> int:
    launcher = _start_launcher()
    try:
        return _main(launcher)
    finally:
        _stop_launcher(launcher)


def _main(launcher) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # outside a checkout of the repo this fails before anything is printed
    sys.path.insert(0, REPO)
    import vectordb_retrieval_tpu_torch  # noqa: F401

    from vectordb_retrieval_tpu_torch.ops import kernels

    card = phase_device()
    work = _start_host_work()
    try:
        host = phase_build(work)
    finally:
        _stop_host_work(work)
    phase_sift_surrogate(host)
    worst = phase_kernels()
    phase_product_precision(card)
    launches = {name: 0 for name in worst}
    # no path of the system calls blockmin: its launches are phase 3's
    launches["blockmin"] = kernels.LAUNCHES["blockmin"]
    main_launches, exact_rows = phase_main_path(card, worst)
    for name, count in main_launches.items():
        launches[name] += count
    paths = [phase_runner_path(card, cfg, worst) for cfg in RUNNER_CONFIGS]
    ct_paths = [phase_covertree_path(card, cfg, worst) for cfg in COVERTREE_CONFIGS]
    def add(run, cover_tree):
        # the cover tree's bf16 launches are all pairs (phase 5c checks it)
        for name, n in run.items():
            if name != "blockmin":
                launches[PAIR if cover_tree and name == "dist_blockmin_bf16" else name] += n

    for path in paths + ct_paths:
        add(path["launches"], path in ct_paths)
    ct_row = ct_paths[0]["rows"]["covertree_v2_2"]
    phase_covertree_walks(card, ct_row)
    add(phase_covertree_fallback(card), True)
    phase_card_vs_host(card, paths + ct_paths)
    phase_persistence_round_trip(card, IVF_CONFIGS[1], "ivf_sq8")
    phase_persistence_round_trip(card, SURROGATE_CONFIG, "hnsw")
    phase_persistence_round_trip(card, SURROGATE_CONFIG, "ivf_pq")
    phase_persistence_round_trip(card, COVERTREE_CONFIGS[0], "covertree_v2_2")
    sift_path = paths[0]
    serving_runs = [phase_serving_flat(card, shape, sift_path, worst)
                    for shape in SERVING_FLAT_SHAPES]
    serving_runs.append(phase_serving_ivf(card, sift_path, worst))
    for run in serving_runs:
        add(run["launches"], False)
    add(phase_out_of_core(card, worst, launcher), False)
    add(phase_graph_stream(card, sift_path, worst), False)
    flagship = phase_throughput(card, 100_000, 384, 96)
    phase_throughput(card, 1_000_000, 128, 96)
    sift = paths[0]["rows"]
    by_kernel = {
        "dist_blockmin_bf16": phase_ivf_throughput(card, paths[0]["name"], "ivf_flat", sift["ivf_flat"]),
        "dist_blockmin_u8": phase_ivf_throughput(card, paths[0]["name"], "ivf_sq8", sift["ivf_sq8"]),
    }
    for row in ("ivf_flat", "ivf_sq8"):
        phase_ivf_throughput(card, paths[1]["name"], row, paths[1]["rows"][row])
    ivf_rescore = phase_ivf_rescore_throughput(card, paths[0]["name"], sift["ivf_flat"])
    phase_lsh_throughput(card, paths[0]["name"], "lsh", sift["lsh"])
    sift_binary = next(p for p in paths if p["name"] == LSH_CONFIGS[-1]["name"])
    phase_lsh_throughput(card, sift_binary["name"], "faiss_lsh", sift_binary["rows"]["faiss_lsh"])

    def k1_launches(path, row):
        return sum(n for key, n in path["counts"].items()
                   if key[0] == f"{row}/search" and key[1] == "dist_blockmin_bf16")

    # the IVF-PQ rows: K1 bf16 over each row's decoded lists
    pq_k1 = [phase_ivf_throughput(card, path["name"], row, path["rows"][row],
                                  launches=k1_launches(path, row))
             for path in paths for row, info in path["rows"].items()
             if info["algo"].artifact.kind == "ivf_pq"]
    graph = {
        (path["name"], row): phase_graph_throughput(card, path["name"], row, info)
        for path in paths for row, info in path["rows"].items()
        if info["algo"].artifact.kind == "graph"
    }
    k2 = graph[(SURROGATE_CONFIG["name"], "hnsw")]["waves"][0]
    glove = phase_glove50_graph(card)
    ct_k1 = phase_covertree_throughput(card, ct_paths[0]["name"], ct_row)
    k3 = phase_assign_throughput(card)
    dsub_launches = {dsub: sum(_dsub_launches(path["counts"], row, dsub)
                               for path in paths for row in path["rows"])
                     for dsub in K3_DSUB}
    k3_dsub = phase_assign_dsub_throughput(card, dsub_launches)
    k4 = phase_blockmin_throughput(card)
    k5 = phase_matmul_floor_throughput(card)
    k6 = phase_block_rescore_throughput(card)
    # 5g: the row-sharded rows through the runner, then the phase's own runs,
    # each beside the unsharded row's numbers from the phases above
    sharded_paths = [phase_runner_path(card, cfg, worst) for cfg in SHARDED_CONFIGS]
    for path in sharded_paths:
        add(path["launches"], False)
    sift_pq = next(t for t in pq_k1 if t["config"] == paths[0]["name"])
    unsharded = {row: {"qps": t["qps"], "batch_device_ms": t["batch_device_ms"]}
                 for row, t in (("ivf_flat", by_kernel["dist_blockmin_bf16"]),
                                ("ivf_sq8", by_kernel["dist_blockmin_u8"]), ("ivf_pq", sift_pq),
                                ("hnsw", graph[(paths[0]["name"], "hnsw")]))}
    unsharded["exact"] = {"qps": sift["exact"]["qps"]}
    for key, run in (("serving_flat", serving_runs[1]), ("serving_ivf", serving_runs[2])):
        unsharded[key] = {"qps": run["qps"]["unfiltered"]["qps"],
                          "batch_device_ms": run["batch_device_ms"]}
    add(phase_sharded(card, sharded_paths, paths[0], unsharded, worst)["launches"], False)
    phase_entry_points(card, flagship, exact_rows["l2"])
    calib = phase_calibration(card)
    add(calib["launches"], False)
    probes = phase_probes(card)
    tuning = phase_tuning(card)
    for run in (probes, tuning):
        for name, n in run["launches"].items():
            if name != "blockmin":
                launches[name] += n
    for run in (calib, probes, tuning):
        for name, err in run["worst"].items():
            worst[name] = max(worst[name], err)

    src = "vectordb_retrieval_tpu_torch/csrc/"
    tpu = "vectordb_retrieval_tpu/ops/pallas_kernels.py"
    entries = [{
        "name": "dist_blockmin", "route": "cuda", "source": src + "dist_blockmin_tc.cu",
        "replaces": f"{tpu}:220", "launches": launches["dist_blockmin"],
        "max_abs_err": worst["dist_blockmin"], "ms": flagship["dist_blockmin_ms"],
        "plain_ms": flagship["plain_ms"], "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"], "fp32_bound_ms": flagship["fp32_bound_ms"],
        "library_ms": flagship["library_ms"],
        "shape": [BATCH, 100_000, 384, flagship["w"]],
    }]
    by_kernel[PAIR] = ct_k1[PAIR]

    def other(t, ms_key):
        keys = ("shape", "plain_ms", "library_ms", "bound_ms", "bound_by", "launches")
        return dict({"ms": t[ms_key]}, **{key: t[key] for key in keys},
                    **({"row": f"{t['config']}/{t['row']}"} if "row" in t else {}))

    for name, t in by_kernel.items():
        entries.append({
            "name": name, "route": "cuda", "source": src + "dist_blockmin_tc.cu",
            "replaces": f"{tpu}:220", "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["dist_blockmin_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"],
        })
    # K1 bf16 over the IVF-PQ rows' reconstructions, beside its IVF-Flat shape
    bf16 = next(e for e in entries if e["name"] == "dist_blockmin_bf16")
    bf16["other_shapes"] = [other(t, "dist_blockmin_ms") for t in pq_k1]
    entries.append({
        "name": "assign", "route": "cuda", "source": src + "assign.cu",
        "replaces": f"{tpu}:53", "launches": launches["assign"],
        "max_abs_err": worst["assign"], "ms": k3["assign_ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "fp32_bound_ms": k3["fp32_bound_ms"],
        "library_ms": k3["library_ms"], "shape": k3["shape"],
        "other_shapes": [other(t, "assign_ms") for t in k3_dsub],
    })
    entries.append({
        "name": "slab_dots", "route": "cuda", "source": src + "slab_dots.cu",
        "replaces": f"{tpu}:653", "also_replaces": f"{tpu}:460",
        "launches": launches["slab_dots"], "max_abs_err": worst["slab_dots"],
        "ms": k2["slab_dots_ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"], "gather_ms": k2["gather_ms"],
        "per_pair_bytes_ms": k2["per_pair_bytes_ms"], "shape": k2["shape"],
        # the block-geometry probe's f32 wave (all its K2 launches beside it)
        # and the benchmark cell glove50.hnsw's two waves
        "other_shapes": [other(probes["k2_f32"], "slab_dots_ms")] + [
            {"ms": wave["slab_dots_ms"], "shape": wave["shape"], "plain_ms": wave["plain_ms"],
             "library_ms": wave["library_ms"], "bound_ms": wave["work_bound_ms"],
             "distinct_share": wave["distinct_share"], "row": f"glove50_surrogate/wave{wave['wave']}"}
            for wave in glove["waves"]],
    })
    entries.append({
        "name": "blockmin", "route": "cuda", "source": src + "blockmin.cu",
        "replaces": f"{tpu}:337", "launches": launches["blockmin"],
        "max_abs_err": worst["blockmin"], "ms": k4["blockmin_ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "fp32_bound_ms": k4["fp32_bound_ms"],
        "library_ms": k4["library_ms"],
        "shape": k4["shape"],
    })
    # K5: the launches are phase 7d's (exp_dbm_tune at both shapes)
    entries.append({
        "name": "matmul_floor", "route": "cuda", "source": src + "matmul_floor.cu",
        "replaces": "scripts/exp_dbm_tune.py:70", "launches": launches["matmul_floor"],
        "max_abs_err": worst["matmul_floor"], "ms": k5[0]["matmul_floor_ms"],
        "plain_ms": k5[0]["plain_ms"], "bound_ms": k5[0]["bound_ms"],
        "bound_by": k5[0]["bound_by"], "fp32_bound_ms": k5[0]["fp32_bound_ms"],
        "library_ms": k5[0]["library_ms"], "shape": k5[0]["shape"],
        "dist_blockmin_ms": k5[0]["dist_blockmin_ms"],
        "k1_loop_bound_ms": k5[0]["k1_loop_bound_ms"],
        "k1_loop_bound_share": k5[0]["k1_loop_bound_share"],
        "other_shapes": [{key: t[key] for key in (
            "shape", "matmul_floor_ms", "dist_blockmin_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "fp32_bound_ms", "k1_loop_bound_ms",
            "k1_loop_bound_share")} for t in k5[1:]],
    })
    # K6: exact search's stage 3 wherever it runs above the dense cut
    entries.append({
        "name": "block_rescore", "route": "cuda", "source": src + "block_rescore.cu",
        "replaces": "vectordb_retrieval_tpu/ops/distances.py:385 (jnp ops, no Pallas kernel)",
        "launches": launches["block_rescore"], "max_abs_err": worst["block_rescore"],
        "ms": k6[0]["block_rescore_ms"], "plain_ms": k6[0]["plain_ms"],
        "bound_ms": k6[0]["bound_ms"], "bound_by": k6[0]["bound_by"],
        "distinct_share": k6[0]["distinct_share"], "shape": k6[0]["shape"],
        "other_shapes": [{key: t[key] for key in (
            "cell", "shape", "block_rescore_ms", "plain_ms", "bound_ms", "bound_by",
            "distinct_share")} for t in k6[1:]],
    })
    # IVF-Flat's stage 3 over bf16 lists, wherever an unfiltered search runs
    entries.append({
        "name": "ivf_block_rescore", "route": "cuda", "source": src + "block_rescore.cu",
        "replaces": "vectordb_retrieval_tpu/ops/ivf.py:521 (jnp ops, no Pallas kernel)",
        "launches": launches["ivf_block_rescore"], "max_abs_err": worst["ivf_block_rescore"],
        "ms": ivf_rescore["ivf_block_rescore_ms"], "plain_ms": ivf_rescore["plain_ms"],
        "bound_ms": ivf_rescore["bound_ms"], "bound_by": ivf_rescore["bound_by"],
        "pairs_bound_ms": ivf_rescore["pairs_bound_ms"],
        "distinct_share": ivf_rescore["distinct_share"], "shape": ivf_rescore["shape"],
    })
    for e in entries:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']}: never launched on the main path")
    emit({"kernels": entries})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "w") as f:
        f.write("\n".join(_LINES) + "\n")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
