"""On-card smoke test of ranklib_tpu_torch's main paths (one NVIDIA GPU):
serving, LambdaMART/MART training, Random Forests, the f32 forest route,
the linear and boosting rankers (Coordinate Ascent, the CLI's default;
RankBoost; AdaRank; Linear Regression), the neural rankers (RankNet,
LambdaRank, ListNet), ``-kcv`` and ``-qrel``, ``-sparse`` for every
ranker (the raw-value rankers on both routes, the COO layer included)
and ``-ana``, the training extensions (``-ckpt``, ``-eventlog``,
``-profile``, ``-resume``, ``-dp``) and the library API, and the opt-in
routes and tools that hold the last kernels: fused lambdas, split
bin-space serving, the predicate epilogue and the compiler probes.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs CUDA and exits non-zero at once without it. With
``--bare-times ROOT`` it instead times the fused-lambda and binning
kernels of the package under ROOT (an older tree, for an A/B call) by
bare launches at this script's shapes and prints one JSON line. It
imports torch, numpy and ranklib_tpu_torch only (never JAX or the
reference package).
Phases, none of whose failures is caught:

1. environment and build: versions, the card's name and power limit, the
   nvcc builds of ``ranklib_tpu_torch/csrc/*.cu`` (one per source, all
   started together) and their ptxas reports;
2. each CUDA kernel against its plain PyTorch version on the card, small
   cases. Forest kernels: odd shapes, uint8 and int16 ids, n_grid == 256,
   documents on thresholds, NaN and ±inf features, a one-leaf tree (the
   bins and frombins kernels bit-equal to their plain versions; atol =
   rtol = 1e-5 against the plain f32 traversal), heap-shaped trees of 150
   leaves whose chunks are too large to stage. Histogram: odd (N, F, B),
   uint8/int16/int32 ids with some ≥ B, bool masks, f32 multiplicities
   and all-zero weights (counts exact, sums atol 2e-4 / rtol 1e-5, two
   launches bit-identical), and int16/int32 ids in [-3, B + 4) through
   both histogram kernels (counts exact: ids < 0 add nothing). Split
   scan: Cn 1 and 2, B 8/11/256/512/1100, feature masks, -mls 0 with
   empty sides (integer histograms with planted ties exactly equal; float
   histograms to rtol 1e-5; two launches and the pair form identical).
   Multi-bag histogram: the same id types and odd B with ids >= B, C
   1/3/8/the RF group size, an all-zero bag and multiplicities up to 3
   (counts exact, two launches bit-identical). f32 forest route: odd
   shapes, NaN/±inf features, more than 256 thresholds on a feature,
   thresholds near ±3.4e38, an input wider than MAX_FEATURES, one
   document, a one-leaf tree and 150-leaf trees whose chunks are too
   large to stage (kernel and plain bit-identical, both within 1e-5 of
   the f32 traversal). On the forest cases also the split route's
   binning kernel (ids equal to ``device_bins``, scores bit-equal to the
   bins kernel) and the predicate epilogue on uint8 and bf16 node tests
   (bit-equal to its plain version); the binning kernel alone on hostile
   grids (1-1,034 thresholds with +inf pads, ±0.0, ±inf, NaN; uint8 and
   int16 ids, the grid read from global memory past 511 thresholds; N and
   F off its tiles and words; ids equal to ``device_bins``); the fused
   lambda round kernel on small fits (queries of 1 to 2,100 documents,
   one of a single label, score ties and ±0.0, pad documents; NDCG, DCG,
   P@k, P@0; atol 2e-5, rtol 1e-4 against its plain version, two launches
   bit-identical, pads 0); the probes' dot (signed int8, 0/1 f32) at
   every tile edge of M, N and K and with int8 sums near 2^31, and the
   int16 compare, exactly;
3. the serving path at the full width the repo measures — 1,000 trees x 10
   leaves over 136 features scoring 262,144 documents — with its launch
   counters at 0: ``TreeEnsemble.eval_matrix`` (host binning, then the
   frombins kernel), the device-resident route (the bins kernel), and the
   CLI's ``-load -test -idv`` and ``-load -rank -score`` flows on a LETOR
   file of 200 queries; then the counters are read;
4. serving checks and times: each forest kernel against its plain version
   on the same device inputs (the frombins kernel bit-equal), the CLI's
   outputs against the plain version, and median times of each route;
   the frombins, bins and f32 kernels on a second 1,000-tree x 10-leaf
   model of heap-shaped trees (each bit-equal, timed);
5. the training path at the bench's width — 1,500 queries of 80-160 docs
   x 136 features, labels 0-4 (~180K docs), LambdaMART 50 trees x 10
   leaves, NDCG@10 — with the histogram and split-scan counters at 0: fit
   A (no validation; each counter must read 50 x 9; a second fit A must
   save the same model text), fit B (300 validation queries, best-round
   rollback); one round under
   ``torch.cuda.set_sync_debug_mode("error")``; the fit's training scores
   against the exported model through ``eval_matrix``; TF32 off;
6. card vs CPU: 10 trees on 200 queries, kernels against plain versions;
7. the training CLI: ``-train -ranker 6`` and ``-ranker 0`` with
   ``-validate -test -idv -save``, then ``-load`` of each saved model;
8. fused lambdas at the training shape under ``RANKLIB_TPU_FUSED_LAMBDA=1``
   (before any profiled phase, so its rounds are timed as fit A's): a
   sort-free and a fused 50-tree fit, the fused one with its counters at 0
   (one lambda launch a round: 50), the kernel vs its plain version on
   the fit's scores, the kernel's own device time (20 bare launches) and
   its wrapper's by events and in host µs, the lambda phase alone against
   the sort-free path, a sync-free round, card vs CPU (10 trees, 200
   queries) and the ``-train -ranker 6`` CLI, each launching the kernel;
9. training kernels at full width: kernel vs plain device times of the
   histogram (root, and a child with ~10% weights) and the scan
   ([1|2, 136, 256, 2], the pair form at 2; exact on integer-valued
   histograms; the kernel's own time by 20 back-to-back bare launches,
   and its wrapper's host time), the root histogram's ``index_add_`` and the
   host time of one histogram call, the peak device memory, one round's
   parts timed alone, the histogram on the root and the 8 right children
   of a tree grown there (replayed from its splits; summed per
   ``grow_tree``) and the device-busy share of a profiled round;
10. Random Forests at the training width — 300 bags of one 100-leaf MART
    tree, -frate 0.3, -srate 1.0, 256 bins, the port's group size — with
    the multi-bag histogram and split-scan counters at 0: the fit (each
    counter must read groups x 99), a second fit saving the same model
    text, one group step under ``set_sync_debug_mode("error")``, card vs
    CPU at 4 bags x 8 leaves on 200 queries (-rtype 0 and a small -rtype
    6), and the multi-bag histogram kernel vs plain and its ``index_add_``
    at the group's width (root and a ~10% child), the host time of a call,
    the split scan on those two as the pair growth passes ([600, 136, 256,
    2] under the bags' feature masks: kernel vs plain, its own time), and
    the kernel on the roots and the 98 right children of a group step
    grown there (replayed from its splits; summed per group step);
11. the f32 forest route at the serving width: 1,000 trees x 10 leaves
    whose first 8 features carry a 1,024-point threshold grid, 262,144
    documents: kernel vs plain (bit-identical) and vs the f32 traversal,
    device times, and ``eval_matrix`` through it;
12. the RF CLI: ``-train -ranker 8 -test -save`` then ``-load -test``;
    three forests trained on different files combined with ``-combine``
    (more than 256 thresholds on a feature), then ``-load -test -idv`` of
    the result with every counter at 0: it must run the f32 kernel and
    print the plain version's metric;
13. split serving under ``RANKLIB_TPU_SERVE_SPLIT=1`` at the serving
    width: the binning kernel vs ``device_bins`` and ``torch.searchsorted``
    (its own device time by 20 bare launches, its wrapper's by events and
    in host µs), the split route bit-equal to the bins kernel and the
    plain version, then ``eval_matrix`` and the CLI's ``-load -test`` with
    the counters at 0 (binning and frombins kernels launched, the fused
    bins kernel not);
14. the predicate epilogue at the serving width: ~9,600 x 262,144 node
    tests of the f32 pack built on the card, uint8 and bf16, bit-equal to
    the plain version and to the f32 route;
15. the compiler probes: the int8 and f32 dot at [256, 2^20] x [2^20, 128]
    (one call, median of 3; the f32 time over ``torch.matmul``'s and the
    int8 time over its bound) and the int16 compare;
16. the linear and boosting rankers on phase 5's training data: Coordinate
    Ascent with RankLib's defaults (-r 5 -i 25 -tolerance 0.001) cut to 2
    sweeps, TF32 enabled outside the fit and every candidate product
    checked to run in full f32 (wall per sweep, peak memory, one
    coordinate step under ``set_sync_debug_mode("error")``); RankBoost
    -round 300 -tc 10 with the histogram counter at 0 (one launch a
    round; the histogram kernel against its plain version on the fit's
    last pair potential at [136, 179,440] int16, B = 11, counts exact, its
    own time by bare launches, ``index_add_`` and the bound; a sync-free
    round); AdaRank -round 500 and Linear Regression (fit and scoring
    walls); card vs CPU on 200 queries (RankBoost's first 20 weak rankers,
    Coordinate Ascent one restart one pass, AdaRank's first 20 picks);
    the CLI: ``-train`` with no ``-ranker`` and with ``-ranker 2|3|9``
    (RankBoost cut to 100 rounds), each with ``-norm zscore -validate
    -test -save``, then ``-load -test``;
17. the neural rankers on phase 5's data (its 300 validation queries as
    validation), RankLib's default nets — RankNet and LambdaRank 1 x 10
    at lr 5e-5, ListNet linear at lr 1e-5 — with epochs cut from 100, 100
    and 1,500 to 2, 2 and 3 for the time limit; TF32 enabled outside the
    fits and every query step and forward pass checked to run in full
    f32; per ranker the wall per epoch, µs per query step, CUDA kernels
    per query step and the device's busy share of a profiled epoch, peak
    memory, one query step under ``set_sync_debug_mode("error")`` and the
    kept parameters rescored against the best epoch; card vs CPU on 200
    queries, 1 epoch each from the same seeded draws (parameters within
    1e-5); the CLI: ``-kcv 3 -ranker 6`` with the histogram, split-scan
    and frombins counters at 0 (each must rise; each ``-kcvmd`` fold model
    loads with ``-load -test``), ``-kcv 3 -ranker 1``, ``-ranker 5|7``
    with ``-validate -test -save`` then ``-load -test``, and ``-load -test
    -qrel`` of permuted judgments, which must print the same line on the
    card as on the CPU;
18. ``-sparse`` at the Yahoo! LTR Set 1 width: a seeded file of 500
    queries of 80-160 documents x 700 features listing the ~10% present
    (and 50 validation queries); the streamed load's wall and host peak
    RSS beside the dense pipeline's (each in a process of its own); with
    the counters at 0, ``-train -ranker 6 -tree 20 -leaf 10 -validate``
    and ``-ranker 8 -bag 4`` through the CLI with and without ``-sparse``
    (byte-equal models and the same printed lines; the fit must receive
    the streamed ``BinnedDataset``, no fallback; B1 and B2 20 x 9 times,
    B7, and B4 launched), ms a round; ``-load -test`` with and without
    ``-sparse`` (the same line, B4 launched); ``-ana -np 10000`` and the
    randomization test timed on the card, equal to the CPU's p-value
    under the same injected signs; B1 at the streamed matrix's shape
    against its plain version and ``index_add_``;
19. ``-sparse`` for the raw-value rankers on phase 18's 700-wide file,
    whose dense [N, F] f32 (~167 MB) is under the device budget: each of
    the seven fit on the dense file and on its host CSR (Coordinate
    Ascent -r 1 -i 10, one sweep; RankBoost -round 100 -tc 10, the B1
    counter at 0: one launch a round; AdaRank -round 500; Linear
    Regression; the nets 2, 2 and 3 epochs, with validation): models and
    scores byte-equal, RankBoost's card ids equal; B1 held on the fit's
    ids (counts exact), timed by bare launches beside ``index_add_``; the
    CLI's -ranker 9 -norm zscore and -ranker 3 with and without -sparse
    (the same lines and model bytes, the fit handed a CSRDataset) and
    ``-load -test -sparse``; then under ``RANKLIB_TPU_DEVICE_DENSE_MB=0``
    the COO route: CA, AdaRank and the three nets twice each
    (bit-identical) and within 2e-5 (CA; AdaRank's alphas, the same
    picks) and 1e-6 (the nets) of the dense fits, the CA sweep's wall
    beside the dense one's and the COO layer's device time at 260, 22
    and 1 candidates; card vs CPU on 40 queries; and the reference's
    wide shape (50,000 features, 200 queries of 40 documents, 10 features
    a document; COO by default): AdaRank -round 5, RankNet -epoch 1 and
    RankBoost -round 20 -tc 10 through the CLI in a process of its own
    (wall, host peak RSS above the process after a warm-up on 2 queries,
    B1 launches), and B1 held on RankBoost's [50,000, 8,000] ids;
20. the extensions on phase 5's training set (written as LETOR text),
    each part with the launch counters at 0: ``-train -ranker 6 -tree 20
    -ckpt 10 -eventlog -profile -save`` through the CLI (B1 and B2 20 x 9
    launches; the checkpoint equal to the saved model; 20 ``"round"``
    records equal to the printed table; B1's and B2's kernels in the
    ``torch.profiler`` trace); ``-resume`` of a 10-tree checkpoint to 20
    trees (the warm-start line, the prior trees verbatim, B1 10 x 9, every
    B4 launch bit-equal to the plain version on its own ids, the metric
    within 0.05 of the straight fit's); ``-dp 2`` as two gloo ranks on
    the card (a ``parallel.dist.Mesh`` of two ranks on one device; every
    rank's model equal, each rank's B1 and B2 20 x 9, none in the parent;
    inside each rank the first tree's 9 B1 launches held against the
    plain version on the rank's own shard, counts exact and sums within
    HIST_TOL, and the two roots counting every training document once;
    B1 alone on rank 0's shard, rebuilt in the parent: exact against the
    plain version, timed beside it, ``index_add_`` and its bound;
    the first tree equal to the single-device fit's; ms a round, from
    the event logs, beside the single-device fit's; the metric within
    0.03); the
    CLI's ``-dp 2`` (on one card the single-device fit: the same model
    bytes; over NCCL when there are more cards); Random Forests ``-bag 4
    -dp 2`` under gloo (every rank's bags equal, B1 4 x 99 a rank, the
    first 9 held in each rank as above, no B7; within 0.03 of the
    single-device forest); ``api.train`` and ``api.evaluate`` (the CLI's
    model bytes and metric line, every B4 launch bit-equal to the plain
    version);
21. ``-dp`` for the other rankers on phase 5's training set, as two gloo
    ranks on the card, with the launch counters at 0, every fit in ONE
    spawned mesh (``parallel.dp.fit_many``): Coordinate Ascent ``-r 2 -i
    10``, 1 sweep; RankBoost and AdaRank ``-round 50``; RankNet,
    LambdaRank and ListNet 1, 1 and 2 epochs with the 300 validation
    queries; the nets on 64 queries (1 epoch at 10x the rates); and
    ``-sparse -dp`` on phase 19's 700-wide file under
    ``RANKLIB_TPU_DEVICE_DENSE_MB=0`` (CA and AdaRank on the COO route,
    RankBoost on its CSR bins, at phase 19's cut). Every rank's model
    equal; CA within 1e-6 (COO: 2e-4) and RankBoost's and AdaRank's weak
    sequences (α within 1e-5) of the single-device fits on the card
    (phase 19's for ``-sparse``); B1 one launch a round on each rank and
    none in the parent, each RankBoost fit's first launch held inside
    each rank against the plain version on the rank's own ids (counts
    exact, sums within HIST_TOL; the ranks' documents and π masses adding
    up to the single-device fit's); B1 alone on rank 0's shard beside the
    plain version, ``index_add_`` and its bound; ms a sweep, round or
    epoch on rank 0 beside the single-device fit's; the 64-query nets
    again on two CPU ranks (within 1e-5); RankNet ``-sparse`` on the COO
    route prints the reference's ``-dp ignored`` line; the CLI's ``-ranker
    4 -dp 2`` (one card: the ``-dp 0`` bytes) and ``-ranker 9 -dp 2`` (the
    reference's line, the same bytes).

Every kernel's line in the JSON record carries its launches on its paths
(the histogram's: LambdaMART's fit, RankBoost's, phase 18's ``-sparse``
fit and phase 19's two ``-sparse`` RankBoost fits, each also under
``paths`` with its shape and times;
B2's, B4's and B7's also phase 18's ``-sparse`` runs; B1's, B2's and B4's
also phase 20's, B1's and B2's ``-dp`` ranks also under ``paths``, with
ms a round beside the single-device fit's; B1's RankBoost ``-dp`` ranks
of phase 21 under ``rankboost_dp``, with the shard's shape and times and
each phase-21 ranker's ms a step beside the single-device one), its
error against
the plain
version, its time and the plain version's, its bound (bytes over 3.35
TB/s or operations over the published peak, whichever is larger, from
this run's inputs) and, where one PyTorch call computes the same
function, that call's time.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
are the kernels' JSON record and the ``nvidia-smi`` name/power-limit line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = {"atol": 1e-5, "rtol": 1e-5}
HIST_TOL = {"atol": 2e-4, "rtol": 1e-5}
# the reference's own tolerance for its fused lambda kernel
# (tests/test_lambda_kernel.py:38-41): f32 pair sums in another order
LAMBDA_TOL = {"atol": 2e-5, "rtol": 1e-4}
FUSED_FLAG, SPLIT_FLAG = "RANKLIB_TPU_FUSED_LAMBDA", "RANKLIB_TPU_SERVE_SPLIT"
# one H100 SXM's published peaks (NVIDIA data sheet): HBM bytes a second,
# and f32 operations a second outside the tensor cores (the units every
# kernel here but the int8 probe runs on)
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12
N_TREES, N_LEAVES, N_FEATURES, N_DOCS = 1000, 10, 136, 262144
# training: bench.py's LambdaMART shape, 50 rounds
FIT_TREES, FIT_QUERIES, FIT_VQUERIES = 50, 1500, 300
# Random Forests at the same width: RankLib's defaults (300 bags of one
# 100-leaf tree), all of them — one group of the port's group size on an
# 80 GB card
RF_BAGS, RF_LEAVES = 300, 100
FIT_NPAD = 180224             # the training set's 179,440 docs, padded
# linear and boosting rankers at the same width: RankLib's defaults, with
# Coordinate Ascent cut from 25 sweeps to 2 for the time limit
CA_PASSES, RB_ROUNDS, RB_TC, ADA_ROUNDS = 2, 300, 10, 500
# the neural rankers at the same width: RankLib's default nets, epochs of
# RankNet, LambdaRank and ListNet cut from 100, 100 and 1,500
NN_EPOCHS = (2, 2, 3)
# -sparse at the feature width of the Yahoo! Learning to Rank Challenge
# Set 1 (700 features, labels 0-4), about 10% of the features present in a
# document; LambdaMART -tree 20 -leaf 10 and Random Forests at 4 bags
SP_FEATURES, SP_QUERIES, SP_VQUERIES, SP_DENSITY = 700, 500, 50, 0.1
SP_TREES, SP_BAGS, SP_PERMS = 20, 4, 10_000
FMAX = float(np.finfo(np.float32).max)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def synthetic_ensemble(n_trees, n_leaves, n_features, rng):
    """Random chain trees (node 2i splits into leaf 2i+1 and node 2i+2),
    weight 0.1 — the same numpy draws as the repo's benchmark fixture."""
    from ranklib_tpu_torch.gbdt.ensemble import Tree, TreeEnsemble

    ens = TreeEnsemble()
    M = 2 * n_leaves - 1
    for _ in range(n_trees):
        feature = rng.integers(0, n_features, size=M).astype(np.int32)
        threshold = rng.normal(size=M).astype(np.float32)
        left = np.full(M, -1, np.int32)
        right = np.full(M, -1, np.int32)
        is_leaf = np.ones(M, bool)
        output = rng.normal(size=M).astype(np.float32)
        for i in range(n_leaves - 1):
            left[2 * i], right[2 * i], is_leaf[2 * i] = 2 * i + 1, 2 * i + 2, 0
        ens.add(Tree(feature, threshold, left, right, is_leaf, output), 0.1)
    return ens


def balanced_ensemble(n_trees, n_leaves, n_features, rng):
    """Random trees in heap shape (node i splits into 2i+1 and 2i+2, the
    first n_leaves - 1 nodes internal: 10 leaves at depth 3 and 4), weight
    0.1 — the walk's other extreme beside the chains."""
    from ranklib_tpu_torch.gbdt.ensemble import Tree, TreeEnsemble

    ens = TreeEnsemble()
    M = 2 * n_leaves - 1
    for _ in range(n_trees):
        feature = rng.integers(0, n_features, size=M).astype(np.int32)
        threshold = rng.normal(size=M).astype(np.float32)
        output = rng.normal(size=M).astype(np.float32)
        left = np.full(M, -1, np.int32)
        right = np.full(M, -1, np.int32)
        is_leaf = np.ones(M, bool)
        for i in range(n_leaves - 1):
            left[i], right[i], is_leaf[i] = 2 * i + 1, 2 * i + 2, 0
        ens.add(Tree(feature, threshold, left, right, is_leaf, output), 0.1)
    return ens


def max_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    torch.cuda.synchronize()
    g, w = got.double().cpu(), want.double().cpu()
    check(g.shape == w.shape, f"{what}: shape {tuple(g.shape)} vs "
                              f"{tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite scores")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.allclose(g, w, **TOL))
    print(f"  {what}: max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
    check(ok, f"{what}: kernel and plain version disagree")
    return err


def event_ms(fn, reps: int) -> float:
    """Median device time of fn() over reps, by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def wall_ms(fn, reps: int) -> float:
    """Median host wall time of fn() over reps, synchronised."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def host_us(fn, reps: int) -> float:
    """Median host time of enqueueing fn() (no synchronisation), in µs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def bound(nbytes: float, ops: float, peak: float = F32_OPS_S) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take for
    a function that moves ``nbytes`` (each input read once, each output
    written once) and does ``ops`` operations of a type whose peak rate is
    ``peak`` — whichever of the two times is larger."""
    b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def walk_ops(ens, X) -> int:
    """Operations of scoring ``X`` with ``ens`` by walking its trees: one
    compare for every internal node a document visits (counted on these
    documents, with the f32 test the kernels' routing equals) and one add
    a (document, tree)."""
    feat, thr, lft, rgt, leaf, _, _, depth = ens._pack()
    dev = X.device
    feat, thr, lft, rgt, leaf = (torch.from_numpy(a).to(dev) for a in
                                 (feat, thr, lft, rgt, leaf))
    T = feat.shape[0]
    tix = torch.arange(T, device=dev)
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, X.shape[0], 4096):
        x = X[lo:lo + 4096]
        rows = torch.arange(x.shape[0], device=dev)[:, None]
        node = torch.zeros((x.shape[0], T), dtype=torch.int64, device=dev)
        for _ in range(depth):
            lf = leaf[tix, node]
            visits += (~lf).sum()
            v = x[rows, feat[tix, node].long()]
            nxt = torch.where(v <= thr[tix, node], lft[tix, node],
                              rgt[tix, node]).long()
            node = torch.where(lf, node, nxt)
    return int(visits) + X.shape[0] * T


def pack_bytes(pack) -> int:
    """Bytes of the split records a forest kernel reads."""
    return nbytes(pack.splits, pack.split_roots, pack.chunk_starts)


def bin_search_ops(X, pack) -> int:
    """Compares of the bins kernel's binary search: one per halving of the
    model's grid, for each value."""
    return X.numel() * int(np.ceil(np.log2(pack.n_grid + 1)))


def heap_model_times(Xd, smi) -> dict:
    """The three forest walks (frombins, bins, f32) on a 1,000-tree x
    10-leaf model of heap-shaped trees (seed 0) over the serving
    documents: each bit-equal to its plain version, device times and
    bounds, so the walks are not judged on chains alone."""
    from ranklib_tpu_torch.ops import forest_eval as fe

    ens = balanced_ensemble(N_TREES, N_LEAVES, N_FEATURES,
                            np.random.default_rng(0))
    pack = ens.forest_pack(N_FEATURES, Xd.device)
    fpack = ens.full_pack(N_FEATURES, Xd.device)
    binsT = fe.device_bins(Xd, pack.grid, pack.n_grid).to(
        fe.ids_dtype(pack.n_grid)).contiguous()
    walk = walk_ops(ens, Xd)
    ops_mm = pack.matmul_operands()
    runs = {
        "frombins": (lambda: fe.forest_eval_frombins(binsT, pack),
                     lambda: fe.forest_eval_frombins_plain(
                         binsT, *ops_mm, tree_chunk=pack.tree_chunk),
                     nbytes(binsT) + pack_bytes(pack), walk),
        "bins": (lambda: fe.forest_eval_bins(Xd, pack),
                 lambda: fe.forest_eval_bins_plain(
                     Xd, pack.grid, *ops_mm, n_grid=pack.n_grid,
                     tree_chunk=pack.tree_chunk),
                 nbytes(Xd, pack.grid) + pack_bytes(pack),
                 walk + bin_search_ops(Xd, pack)),
        "full": (lambda: fe.forest_eval_full(Xd, fpack),
                 lambda: fe.forest_eval_full_plain(
                     Xd, *fpack.matmul_operands(),
                     tree_chunk=fpack.tree_chunk),
                 nbytes(Xd) + pack_bytes(fpack), walk),
    }
    out = {}
    for name, (kernel, plain_fn, in_bytes, ops) in runs.items():
        plain = plain_fn()
        got = kernel()
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"{name} kernel not bit-equal to "
                                       f"plain on the heap-shaped model")
        ms = event_ms(kernel, 20)
        plain_ms = event_ms(plain_fn, 3)
        bnd = bound(in_bytes + nbytes(plain), ops)
        print(f"  heap-shaped model ({N_TREES} trees x {N_LEAVES} leaves, "
              f"max_depth {pack.max_depth}): {name} kernel {ms:.4f} ms vs "
              f"plain {plain_ms:.4f} ms, bit-equal; bound {bnd[0]:.4f} ms "
              f"({bnd[1]}, {ops} operations)  [{smi}]")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound": bnd}
    return out


def pred_matrix(fpack, Xd, rows: int = 1024) -> torch.Tensor:
    """The predicate epilogue's input: 0/1 node tests ``x[fid] <= thr``
    ``[nch·TCM, N]`` uint8 of an f32 pack (NaN tests 0), built on the card
    a block of rows at a time."""
    fid, thr = fpack.fid_full.long(), fpack.thr_full
    XT = Xd.T.contiguous()
    out = torch.empty((fid.shape[0], Xd.shape[0]), dtype=torch.uint8,
                      device=Xd.device)
    for lo in range(0, fid.shape[0], rows):
        out[lo:lo + rows] = (XT.index_select(0, fid[lo:lo + rows])
                             <= thr[lo:lo + rows, None])
    return out


def small_case_checks(dev) -> None:
    from ranklib_tpu_torch.gbdt.ensemble import Tree
    from ranklib_tpu_torch.ops import forest_eval as fe

    def case(name, n_trees, n_leaves, F, N, seed, grid256=False,
             lone_leaf=False, heap=False):
        rng = np.random.default_rng(seed)
        ens = (balanced_ensemble if heap else synthetic_ensemble)(
            n_trees, n_leaves, F, rng)
        if grid256:                       # 256 distinct thresholds on f0
            pool = np.linspace(-2.0, 2.0, 256).astype(np.float32)
            i = 0
            for t in ens.trees:
                for n in np.flatnonzero(~t.is_leaf):
                    t.feature[n], t.threshold[n] = 0, pool[i % 256]
                    i += 1
        if lone_leaf:
            ens.add(Tree([0], [0.0], [-1], [-1], [True], [0.75]), 0.5)
        X = rng.normal(size=(N, F)).astype(np.float32)
        thrs = np.concatenate([t.threshold[~t.is_leaf] for t in ens.trees])
        flat = X.reshape(-1)
        pick = rng.integers(0, len(thrs), size=flat.size // 3)
        flat[: pick.size] = thrs[pick]               # docs ON thresholds
        if N > 11:
            X[3, F - 1] = -np.inf
            X[7, 0] = np.inf if not grid256 else 5.0  # past every threshold
            X[11 % N, min(2, F - 1)] = np.nan
            X[::17, 1 % F] = np.nan
        pack = ens.forest_pack(F, dev)
        Xd = torch.from_numpy(X).to(dev)
        walk = traversal(ens, Xd)
        bins_k = fe.forest_eval_bins(Xd, pack)
        bins_p = fe.forest_eval_bins_plain(
            Xd, pack.grid, *pack.matmul_operands(), n_grid=pack.n_grid,
            tree_chunk=pack.tree_chunk)
        print(f" case {name}: {n_trees} trees x {n_leaves} leaves, F={F}, "
              f"N={N}, n_grid={pack.n_grid}")
        max_err(bins_k, bins_p, "bins kernel vs plain")
        check(torch.equal(bins_k, bins_p), f"case {name}: bins kernel not "
                                           f"bit-equal to plain")
        max_err(bins_k, walk, "bins kernel vs f32 traversal")
        ids = fe.device_bins(Xd, pack.grid, pack.n_grid)
        dtypes = [torch.int16] if pack.n_grid >= 256 else [torch.uint8,
                                                          torch.int16]
        for dt in dtypes:
            binsT = ids.to(dt).contiguous()
            fb_k = fe.forest_eval_frombins(binsT, pack)
            fb_p = fe.forest_eval_frombins_plain(
                binsT, *pack.matmul_operands(), tree_chunk=pack.tree_chunk)
            max_err(fb_k, fb_p, f"frombins kernel ({dt}) vs plain")
            check(torch.equal(fb_k, fb_p), f"case {name}: frombins kernel "
                                           f"({dt}) not bit-equal to plain")
            max_err(fb_k, walk, f"frombins kernel ({dt}) vs f32 traversal")
        narrow = fe.device_bins_narrow(Xd, pack)
        torch.cuda.synchronize()
        check(narrow.dtype == fe.ids_dtype(pack.n_grid)
              and torch.equal(narrow.to(torch.int32), ids),
              f"case {name}: the binning kernel's ids differ from device_bins")
        split = fe.forest_eval_bins_split(Xd, pack)
        torch.cuda.synchronize()
        check(torch.equal(split, bins_k),
              f"case {name}: the split route is not bit-equal to the bins "
              f"kernel")
        print(f"  binning kernel ({narrow.dtype}) ids equal device_bins; "
              f"split route bit-equal to the bins kernel")
        fpack = ens.full_pack(F, dev)
        ops = fpack.matmul_operands()[2:]
        predT = pred_matrix(fpack, Xd)
        plain = fe.forest_eval_pred_plain(predT, *ops,
                                          tree_chunk=fpack.tree_chunk)
        for dt in (torch.uint8, torch.bfloat16):
            got = fe.forest_eval_pred(predT.to(dt), fpack)
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"case {name}: predicate epilogue "
                                           f"({dt}) not bit-equal to plain")
            max_err(got, walk, f"predicate epilogue ({dt}) vs f32 traversal")

    case("A", 50, 10, 20, 300, seed=7)
    case("B-odd", 23, 7, 13, 257, seed=11, lone_leaf=True)
    case("C-grid256", 60, 6, 12, 400, seed=5, grid256=True)
    case("D-one-doc", 7, 3, 5, 1, seed=3)
    # chunks of 25 x 149 split records, too large to stage: the frombins
    # kernel's walk through the read-only cache
    case("E-big-trees", 30, 150, 40, 300, seed=9, heap=True)
    # chains of 150 leaves: paths of up to 149 node tests, past the
    # predicate epilogue's packed byte count (127), counted per document
    case("F-long-chains", 6, 150, 40, 300, seed=13)


def round_data(ds, metric, n_pad_docs, dev):
    """The fused round's per-fit data (``BoostData.fused``) of dataset
    ``ds`` with ``n_pad_docs`` pad documents, as a fit under
    RANKLIB_TPU_FUSED_LAMBDA=1 builds it; the bins are never read."""
    from ranklib_tpu_torch.data.dataset import flatten_meta
    from ranklib_tpu_torch.gbdt.boost import make_boost_data
    from ranklib_tpu_torch.metrics.base import create_scorer

    labels, _ = flatten_meta(ds)
    N = labels.shape[0]
    os.environ[FUSED_FLAG] = "1"
    try:
        data, _, _ = make_boost_data(
            ds, np.zeros((N + n_pad_docs, 1), np.uint8),
            np.concatenate([labels, np.zeros(n_pad_docs, np.float32)]), N,
            None, None, dev, scorer=create_scorer(metric))
    finally:
        os.environ.pop(FUSED_FLAG, None)
    return data


def lambda_small_checks(dev) -> float:
    """The fused round kernel vs its plain version on small fits: score
    ties and ±0.0, queries of 1 and 2 documents, of one label, up to
    1,100 documents and of 2,100 (past the 2,048 a block stages: the
    scratch-row path), pad documents; NDCG@10, DCG@5, P@4, P@0 (atol
    2e-5, rtol 1e-4; two launches bit-identical; pads 0)."""
    from ranklib_tpu_torch.data.dataset import Dataset, Query
    from ranklib_tpu_torch.ops import lambda_kernel as LK

    rng = np.random.default_rng(29)
    worst = 0.0
    for sizes in ([1, 2, 7, 33], [80, 130, 160, 97, 121], [512, 640, 1100],
                  [2100, 40]):
        queries = []
        for i, n in enumerate(sizes):
            labels = rng.integers(0, 5, n).astype(np.float32)
            if i == 2:
                labels[:] = 3.0                      # one label: no pairs
            queries.append(Query(str(i + 1), labels,
                                 np.zeros((n, 1), np.float32), [""] * n))
        ds = Dataset(queries, 1)
        n_docs = sum(sizes)
        s = (np.round(rng.normal(size=n_docs + 8) * 4) / 4).astype(
            np.float32)
        s[rng.random(s.size) < 0.05] = 0.0
        s[rng.random(s.size) < 0.05] = -0.0
        scores = torch.from_numpy(s).to(dev)
        for metric in ("NDCG@10", "DCG@5", "P@4", "P@0"):
            rd = round_data(ds, metric, 7, dev).fused
            got = LK.lambda_round(rd, scores)
            again = LK.lambda_round(rd, scores)
            want = LK.lambda_round_plain(rd, scores)
            torch.cuda.synchronize()
            what = f"lambda kernel {sizes} {metric}"
            for g, a, w in zip(got, again, want):
                check(torch.equal(g, a), f"{what}: not reproducible")
                check(torch.allclose(g, w, **LAMBDA_TOL),
                      f"{what}: kernel and plain version disagree")
                check(not g[n_docs:].any(), f"{what}: pad documents not 0")
                worst = max(worst, float((g - w).abs().max()))
        print(f"  lambda kernel, queries of {sizes} docs x NDCG@10/DCG@5/"
              f"P@4/P@0: ok")
    print(f"  lambda kernel small cases: max_abs_err={worst:.3e}, "
          f"bit-reproducible")
    return worst


def bins_only_small_checks(dev) -> None:
    """The split route's binning kernel against ``device_bins`` (ids equal)
    on hostile grids: sorted rows of 1-1,034 thresholds with +inf pads and
    0.0 among them, features on, between and past them, ±0.0, ±inf, NaN;
    uint8 ids below 256 thresholds, int16 at 256 and past 511 (the grid
    read from global memory); N not a multiple of the kernel's 128
    documents or 4-document words, F not a multiple of its 16 features or
    of 4 (scalar reads of X)."""
    from types import SimpleNamespace

    from ranklib_tpu_torch.ops import forest_eval as fe

    rng = np.random.default_rng(31)
    for N, F, n_grid in [(203, 13, 88), (1, 5, 7), (129, 16, 256),
                         (1000, 20, 255), (4097, 33, 1), (300, 136, 88),
                         (2050, 12, 600), (96, 3, 256)]:
        grid = np.full((F, n_grid), np.inf, np.float32)
        for f in range(F):
            k = n_grid if f % 3 else int(rng.integers(1, n_grid + 1))
            vals = np.unique(np.concatenate([[0.0], rng.normal(size=k) * 2]))
            grid[f, :k] = np.sort(vals[:k]).astype(np.float32)
        X = (rng.normal(size=(N, F)) * 2).astype(np.float32)
        on = rng.random((N, F)) < 0.3
        X[on] = grid[np.nonzero(on)[1], rng.integers(0, n_grid,
                                                     size=int(on.sum()))]
        X[~np.isfinite(X)] = 1.0
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e30],
                           np.float32)
        X[rng.random((N, F)) < 0.05] = 0.0
        X.reshape(-1)[rng.integers(0, X.size, size=min(X.size, 64))] = \
            special[rng.integers(0, 6, size=min(X.size, 64))]
        Xd = torch.from_numpy(X).to(dev)
        gd = torch.from_numpy(grid).to(dev)
        pack = SimpleNamespace(n_features=F, n_grid=n_grid, grid=gd,
                               device=dev)
        ids = fe.device_bins_narrow(Xd, pack)
        want = fe.device_bins(Xd, gd, n_grid)
        torch.cuda.synchronize()
        check(ids.dtype == fe.ids_dtype(n_grid) and ids.shape == (F, N),
              f"binning kernel ({N}, {F}, {n_grid}): wrong ids' type or "
              f"shape")
        check(torch.equal(ids.to(torch.int32), want),
              f"binning kernel ({N}, {F}, {n_grid}): ids differ from "
              f"device_bins")
        print(f"  binning kernel N={N} F={F} n_grid={n_grid} "
              f"({ids.dtype}): ids equal device_bins")


def probe_small_checks(dev) -> None:
    """The probes' kernels vs plain, exactly: signed int8 and 0/1 f32
    products at every tile edge (M, N and K each below, at and past the
    kernels' 128 x 128 tiles and K steps; unaligned rows take the
    element-wise staging), int8 sums near 2^31, the int16 compare over the
    type's range."""
    from ranklib_tpu_torch.tools import probes as P

    rng = np.random.default_rng(31)
    shapes = [(M, N, K) for M in (1, 17, 255) for N in (1, 7, 129)
              for K in (1, 31, 33, 4097)]
    shapes += [(19, 5, 33), (256, 128, 5000), (70, 130, 4097),
               (256, 128, 4096)]
    for M, N, K in shapes:
        a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(
            np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(
            np.int8)).to(dev)
        check(torch.equal(P.dot(a, b), P.dot_plain(a, b)),
              f"int8 dot ({M}, {N}, {K}) differs from plain")
        a01, b01 = (a > 0).float(), (b > 0).float()
        check(torch.equal(P.dot(a01, b01), P.dot_plain(a01, b01)),
              f"f32 dot ({M}, {N}, {K}) differs from plain")
    # every entry -128: sums of K x 2^14, the largest below 2^31 at K near
    # 2^17 (2^17 itself would reach 2^31); aligned and unaligned K
    for M, N, K in ((17, 129, (1 << 17) - 16), (33, 64, (1 << 17) - 1)):
        a = torch.full((M, K), -128, dtype=torch.int8, device=dev)
        b = torch.full((K, N), -128, dtype=torch.int8, device=dev)
        got = P.dot(a, b)
        check(torch.equal(got, P.dot_plain(a, b))
              and bool((got == K << 14).all()),
              f"int8 dot ({M}, {N}, {K}) of -128s is not {K << 14}")
    x = torch.from_numpy(np.arange(-32768, 32767, 7).astype(np.int16)).to(
        dev)
    for thr in (3, -5):
        check(torch.equal(P.compare(x, thr), P.compare_plain(x, thr)),
              "int16 compare differs from plain")
    print(f"  probes: int8 and f32 dot at {len(shapes)} shapes (every tile "
          f"edge), int8 sums near 2^31, int16 compare: exact")


def hist_small_checks(dev) -> float:
    """Histogram kernel vs plain on odd shapes, id types, weights."""
    from ranklib_tpu_torch.ops import histogram as H

    rng = np.random.default_rng(17)
    worst = 0.0
    for N, F, B in [(300, 6, 8), (1024, 17, 128), (700, 9, 256),
                    (5000, 13, 512), (1, 3, 11)]:
        grad = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
        weights = {"bool": rng.random(N) > 0.3,
                   "mult": rng.integers(0, 4, N).astype(np.float32),
                   "zero": np.zeros(N, np.float32)}
        for dt, top in ((torch.uint8, 256), (torch.int16, 32767),
                        (torch.int32, 1 << 30)):
            # some ids >= B where the type holds them
            ids = rng.integers(0, min(B + 3, top), size=(F, N))
            binsT = torch.from_numpy(ids).to(dt).contiguous().to(dev)
            for wname, w in weights.items():
                wt = torch.from_numpy(w).to(dev)
                got = H.histogram(binsT, grad, wt, B)
                again = H.histogram(binsT, grad, wt, B)
                want = H.histogram_plain(binsT, grad, wt, B)
                torch.cuda.synchronize()
                check(got.shape == want.shape == (F, B, 2),
                      f"histogram shape {tuple(got.shape)}")
                check(torch.equal(got[..., 1], want[..., 1]),
                      f"histogram counts differ ({N}, {F}, {B}, {dt}, "
                      f"{wname})")
                check(torch.allclose(got[..., 0], want[..., 0], **HIST_TOL),
                      f"histogram sums differ ({N}, {F}, {B}, {dt}, "
                      f"{wname})")
                check(torch.equal(got, again),
                      f"histogram not reproducible ({N}, {F}, {B}, {dt})")
                if wname == "zero":
                    check(not got.any(), "all-zero weights gave non-zero")
                worst = max(worst, float((got - want).abs().max()))
        print(f"  histogram ({N}, {F}, {B}) x uint8/int16/int32 x "
              f"bool/mult/zero: ok")
    # ids < 0 add nothing, in the kernels and the plain versions alike;
    # feature 0 included (its flat index would be negative)
    N, F, B, C = 900, 7, 256, 3
    grads = torch.from_numpy(rng.normal(size=(C, N)).astype(np.float32)).to(
        dev)
    w = torch.from_numpy(rng.integers(0, 4, (C, N)).astype(np.float32)).to(
        dev)
    for dt in (torch.int16, torch.int32):
        ids = rng.integers(-3, B + 4, size=(F, N))
        ids[0, :50] = -1
        binsT = torch.from_numpy(ids).to(dt).contiguous().to(dev)
        got = H.histogram(binsT, grads[0], w[0], B)
        want = H.histogram_plain(binsT, grads[0], w[0], B)
        mgot = H.histogram_multi(binsT, grads, w, B)
        mwant = H.histogram_multi_plain(binsT, grads, w, B)
        torch.cuda.synchronize()
        kept = ((torch.from_numpy(ids) >= 0) & (torch.from_numpy(ids) < B))
        check(torch.equal(got[..., 1], want[..., 1])
              and torch.equal(mgot[..., 1], mwant[..., 1])
              and float(want[..., 1].sum()) == float(
                  (kept.to(dev) * w[0]).sum()),
              f"negative {dt} ids: counts differ from plain")
        check(torch.allclose(got[..., 0], want[..., 0], **HIST_TOL)
              and torch.allclose(mgot[..., 0], mwant[..., 0], **HIST_TOL),
              f"negative {dt} ids: sums differ from plain")
        worst = max(worst, float((got - want).abs().max()),
                    float((mgot - mwant).abs().max()))
    print("  histogram and multi-bag histogram, int16/int32 ids in [-3, "
          "B + 4): counts exact")
    print(f"  histogram small cases: max_abs_err={worst:.3e}, counts exact, "
          f"bit-reproducible")
    return worst


def _flat_gains(hist, mls):
    """All candidate gains [Cn, F*B] of the plain formula (for the
    near-tie test of float histograms)."""
    c_l = torch.cumsum(hist[..., 1], dim=2)
    s_l = torch.cumsum(hist[..., 0], dim=2)
    c_r, s_r = c_l[..., -1:] - c_l, s_l[..., -1:] - s_l
    mls = max(float(mls), 1e-9)
    g = torch.where((c_l >= mls) & (c_r >= mls),
                    s_l * s_l / torch.clamp(c_l, min=1.0)
                    + s_r * s_r / torch.clamp(c_r, min=1.0), -torch.inf)
    return g.reshape(g.shape[0], -1)


def scan_small_checks(dev) -> float:
    """Split-scan kernel vs plain: exact on integer histograms (planted
    ties, empty sides at -mls 0, feature masks), rtol 1e-5 on floats."""
    from ranklib_tpu_torch.ops import split_scan as SS

    rng = np.random.default_rng(23)
    worst = 0.0
    for Cn in (1, 2):
        for B in (8, 11, 256, 512, 1100):
            F = 9
            counts = rng.integers(0, 4, (Cn, F, B)).astype(np.float32)
            counts[:, :, 0] = 0                      # empty left sides
            isums = (rng.integers(-3, 4, (Cn, F, B)) * (counts > 0))
            isums[:, 4] = isums[:, 1]                # cross-feature tie
            counts[:, 4] = counts[:, 1]
            isums[:, 6] = 0                          # every bin ties
            fsums = rng.normal(size=(Cn, F, B)) * (counts > 0)
            for kind, sums in (("int", isums), ("float", fsums)):
                hist = torch.from_numpy(np.stack(
                    [sums, counts], axis=-1).astype(np.float32)).to(dev)
                for mls in (0, 1, 3):
                    for fm in (None, torch.from_numpy(
                            rng.random((Cn, F)) > 0.3).to(dev)):
                        got = SS.best_splits(hist.contiguous(), mls, fm)
                        want = SS.best_splits_plain(hist, mls, fm)
                        again = SS.best_splits(hist.contiguous(), mls, fm)
                        pair = SS.best_splits(
                            (hist[:1].contiguous(), hist[1:].contiguous())
                            if Cn == 2 else (hist[:0].contiguous(),
                                             hist.contiguous()), mls, fm)
                        torch.cuda.synchronize()
                        what = f"scan Cn={Cn} B={B} {kind} mls={mls}"
                        check(all(torch.equal(a, b) for a, b in
                                  zip(got, again)), f"{what}: two launches "
                                                    f"differ")
                        check(all(torch.equal(a, b) for a, b in
                                  zip(got, pair)), f"{what}: the pair form "
                                                   f"differs")
                        if kind == "int":
                            for a, b in zip(got, want):
                                check(torch.equal(a.cpu(), b.cpu()),
                                      f"{what}: not exactly equal")
                            continue
                        gk, gp = got[0].cpu(), want[0].cpu()
                        check(torch.equal(got[3].cpu(), want[3].cpu()),
                              f"{what}: ok flags differ")
                        fin = torch.isfinite(gp)
                        check(torch.allclose(gk[fin], gp[fin], rtol=1e-5,
                                             atol=0.0), f"{what}: gains")
                        flat = _flat_gains(hist, mls).cpu()
                        if fm is not None:
                            flat = torch.where(
                                fm.cpu().repeat_interleave(B, dim=1), flat,
                                -torch.inf)
                        top2 = torch.topk(flat, 2, dim=1).values
                        clear = (top2[:, 0] - top2[:, 1]
                                 > 1e-5 * top2[:, 0].abs())
                        for i in torch.nonzero(clear & fin).flatten():
                            check(int(got[1][i]) == int(want[1][i])
                                  and int(got[2][i]) == int(want[2][i]),
                                  f"{what}: split differs")
                        worst = max(worst, float(
                            (gk[fin] - gp[fin]).abs().max())
                            if fin.any() else 0.0)
            print(f"  scan Cn={Cn} B={B}: int exact, float ok, two launches "
                  f"and the pair form identical")
    print(f"  split-scan small cases: max_abs_err (float) {worst:.3e}")
    return worst


def synth_queries(n_queries, n_features, seed, w_seed, min_docs=80,
                  max_docs=160, gmax=4, signal=2.5, density=None):
    """The repo's synthetic LETOR draws (its test fixtures' linear-signal
    branch, copied because the fixtures import the JAX package): per
    query, N(0,1) features and graded labels 0..gmax by quantiles of a
    planted linear score plus noise. ``density``: the share of features
    present in a document (the others 0, drawn before the labels)."""
    from ranklib_tpu_torch.data.dataset import Dataset, Query

    rng = np.random.default_rng(seed)
    w_true = np.random.default_rng(w_seed).normal(size=n_features)
    w_true /= np.linalg.norm(w_true)
    queries = []
    for qi in range(n_queries):
        n = int(rng.integers(min_docs, max_docs + 1))
        feats = rng.normal(size=(n, n_features)).astype(np.float32)
        if density is not None:
            feats *= rng.random((n, n_features)) < density
        raw = signal * feats @ w_true + rng.normal(size=n)
        qtiles = np.quantile(raw, np.linspace(0, 1, gmax + 2)[1:-1])
        labels = np.digitize(raw, qtiles).astype(np.float32)
        queries.append(Query(str(qi + 1), labels, feats, [""] * n))
    return Dataset(queries, n_features)


def write_dataset(path, ds):
    from ranklib_tpu_torch.data.dataset import flatten

    X, labels, qptr = flatten(ds)
    write_letor(path, X, labels, qptr)


@contextlib.contextmanager
def timed_steps(cls, times: list):
    """Time each call of the step (a round, or a sweep) that
    ``cls.prepare_fit`` returns first, in every fit inside the block
    (synchronised wall ms a call); the fits are otherwise the users'
    ``fit``."""
    orig = cls.prepare_fit

    def prepare(self, *args, **kw):
        step, *rest = orig(self, *args, **kw)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a, **k)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        return (timed, *rest)

    cls.prepare_fit = prepare
    try:
        yield
    finally:
        cls.prepare_fit = orig


def timed_rounds(times: list):
    """Time each round of every LambdaMART fit inside the block."""
    from ranklib_tpu_torch.models.gbdt import LambdaMART

    return timed_steps(LambdaMART, times)


def quiet(fn, *args, **kw):
    """Run fn with its console lines captured; returns (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def training_phase(dev) -> dict:
    """Fits A and B at the bench's width, the sync-free round, and the
    fit's scores against the exported model."""
    from ranklib_tpu_torch.data.dataset import flatten
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import lambda_kernel as LK
    from ranklib_tpu_torch.ops import split_scan as SS

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls are enabled")
    train = synth_queries(FIT_QUERIES, N_FEATURES, seed=3, w_seed=11)
    vali = synth_queries(FIT_VQUERIES, N_FEATURES, seed=4, w_seed=11)
    scorer = create_scorer("NDCG@10")
    hp = dict(n_trees=FIT_TREES, n_leaves=N_LEAVES, learning_rate=0.1,
              n_threshold=256, min_leaf_support=1, early_stop=0)
    print(f"train: {len(train.queries)} queries, {train.n_docs} docs x "
          f"{N_FEATURES} features; validation: {len(vali.queries)} queries")

    times_a, times_b = [], []
    fit_a = LambdaMART(**hp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    H.histogram.launches = 0
    SS.best_splits.launches = 0
    LK.lambda_round.launches = 0
    with timed_rounds(times_a):
        quiet(fit_a.fit, train, scorer, device=dev)
    torch.cuda.synchronize()
    launches = {"histogram": H.histogram.launches,
                "split_scan": SS.best_splits.launches}
    check(LK.lambda_round.launches == 0,
          "the default route launched the fused lambda kernel")
    peak = torch.cuda.max_memory_allocated(dev)
    want = FIT_TREES * (N_LEAVES - 1)
    print(f"fit A: {FIT_TREES} trees; launches {launches} (want {want} "
          f"each); peak device memory {peak / 2**20:.1f} MiB")
    check(all(v == want for v in launches.values()),
          "histogram/split-scan launches over fit A are not 50 x 9")
    tm = fit_a.fit_state.train_m[:FIT_TREES].cpu().numpy()
    print(f"  train NDCG@10 round 1 {tm[0]:.4f} -> round {FIT_TREES} "
          f"{tm[-1]:.4f}")
    check(bool(np.isfinite(tm).all()) and tm[-1] > tm[0],
          "train NDCG@10 did not rise over fit A")
    feats, _, _ = flatten(train)
    fit_scores = fit_a.fit_state.scores[:feats.shape[0]].cpu().numpy()
    rescored = fit_a.ensemble.eval_matrix(feats, dev)
    err = float(np.abs(fit_scores - rescored).max())
    print(f"  fit scores vs eval_matrix of the exported model: "
          f"max_abs_err={err:.3e}")
    check(len(fit_a.ensemble) == FIT_TREES and err <= 1e-4,
          "the fit's scores disagree with its exported model")

    again = LambdaMART(**hp)
    quiet(again.fit, train, scorer, device=dev)
    check(again.model_str() == fit_a.model_str(),
          "two fits of the same data gave different models")
    print("  a second fit A gave the same model text (deterministic)")

    step, state, data, _ = LambdaMART(**hp).prepare_fit(train, scorer, None,
                                                      dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = step(state, 0, data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(state.scores).all()), "sync-free round: NaN")
    print("  one round ran under set_sync_debug_mode('error'): no host sync")

    fit_b = LambdaMART(**hp)
    with timed_rounds(times_b):
        quiet(fit_b.fit, train, scorer, vali, device=dev)
    vm = fit_b.fit_state.val_m[:FIT_TREES].cpu().numpy()
    best = int(np.nanargmax(vm)) + 1
    print(f"fit B: validation NDCG@10 round 1 {vm[0]:.4f}, best round "
          f"{best} ({vm[best - 1]:.4f}); kept {len(fit_b.ensemble)} trees")
    check(bool(np.isfinite(vm).all()), "validation metric not finite")
    check(len(fit_b.ensemble) == best, "rollback kept the wrong length")
    ms_a, ms_b = float(np.median(times_a)), float(np.median(times_b))
    print(f"  median wall ms per round: fit A {ms_a:.3f}, fit B {ms_b:.3f}")
    return {"launches": launches, "peak": peak, "ms_a": ms_a, "ms_b": ms_b,
            "data": data, "train": train, "vali": vali, "train_m": tm}


def card_vs_cpu(dev) -> None:
    """10 trees on 200 queries, plain versions on the CPU vs kernels."""
    from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
    from ranklib_tpu_torch.models.gbdt import LambdaMART

    ds = synth_queries(200, N_FEATURES, seed=5, w_seed=11)
    scorer = create_scorer("NDCG@10")
    cpu = torch.device("cpu")
    fits = []
    for d in (cpu, dev):
        r = LambdaMART(n_trees=10, n_leaves=N_LEAVES, early_stop=0)
        t0 = time.perf_counter()
        quiet(r.fit, ds, scorer, device=d)
        m, _ = score_dataset(scorer, ds, r.eval_dataset(ds, d), d)
        fits.append((r.ensemble.trees, m))
        print(f"  {d.type}: fit {time.perf_counter() - t0:.1f} s, train "
              f"NDCG@10 {m:.6f}")
    (cpu_trees, cpu_m), (dev_trees, dev_m) = fits
    same = [all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
                ("feature", "threshold", "left", "right", "is_leaf"))
            for a, b in zip(cpu_trees, dev_trees)]
    print(f"card vs CPU: {sum(same)} of 10 trees structurally identical; "
          f"train NDCG@10 differs by {abs(cpu_m - dev_m):.2e}")
    check(same[0], "the first tree differs between the card and the CPU")
    check(abs(cpu_m - dev_m) <= 1e-3,
          "train NDCG@10 differs between the card and the CPU")


def training_cli(tmp, rankers=(6, 0)) -> None:
    """-train with -validate -test -idv -save for each ranker, then -load
    of each saved model: the same test metric."""
    from ranklib_tpu_torch import cli

    paths = {}
    for name, nq, seed in (("train", 300, 6), ("vali", 60, 7),
                           ("test", 60, 8)):
        paths[name] = os.path.join(tmp, f"{name}.txt")
        write_dataset(paths[name], synth_queries(nq, N_FEATURES, seed, 11))
    for ranker in rankers:
        model = os.path.join(tmp, f"model{ranker}.txt")
        rc, out = quiet(cli.main, [
            "-train", paths["train"], "-ranker", str(ranker),
            "-metric2t", "NDCG@10", "-validate", paths["vali"],
            "-test", paths["test"], "-metric2T", "ERR@10", "-idv",
            os.path.join(tmp, f"idv{ranker}.txt"), "-tree", "20", "-leaf",
            str(N_LEAVES), "-save", model])
        check(rc == 0, f"-train -ranker {ranker} failed:\n{out[-2000:]}")
        trained = [ln for ln in out.splitlines() if " on " in ln]
        rc, out = quiet(cli.main, ["-load", model, "-test", paths["test"],
                                   "-metric2T", "ERR@10"])
        check(rc == 0, f"-load of the -ranker {ranker} model failed")
        loaded = [ln for ln in out.splitlines() if " on test data" in ln]
        print(f"  -ranker {ranker}: {'; '.join(trained)}; -load: "
              f"{loaded[0]}")
        check(loaded[0] in trained,
              "the loaded model's test metric differs from training's")


def training_kernel_times(fit) -> tuple:
    """Histogram and scan, kernel vs plain, at the bench's width."""
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import split_scan as SS

    data = fit["data"]
    binsT = data.binned_T
    F, N = binsT.shape
    B = 256
    rng = np.random.default_rng(9)
    dev = binsT.device
    grad = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dev)
    root_w = data.doc_mask
    child_w = data.doc_mask & torch.from_numpy(rng.random(N) < 0.1).to(dev)
    out = {}
    for name, w in (("root", root_w), ("child", child_w)):
        got = H.histogram(binsT, grad, w, B)
        want = H.histogram_plain(binsT, grad, w, B)
        torch.cuda.synchronize()
        check(torch.equal(got[..., 1], want[..., 1]),
              f"histogram counts differ at full width ({name})")
        check(torch.allclose(got[..., 0], want[..., 0], **HIST_TOL),
              f"histogram sums differ at full width ({name})")
        check(torch.equal(got, H.histogram(binsT, grad, w, B)),
              "histogram not reproducible at full width")
        out[name] = (got, float((got - want).abs().max()),
                     event_ms(lambda: H.histogram(binsT, grad, w, B), 20),
                     event_ms(lambda: H.histogram_plain(binsT, grad, w, B),
                              3))
        print(f"  histogram {name} [{F}, {N}] uint8, "
              f"{int(w.sum())} weighted docs: kernel {out[name][2]:.4f} ms "
              f"vs plain {out[name][3]:.4f} ms; max_abs_err "
              f"{out[name][1]:.3e}")
    # the root's library call: one index_add_ over the flat f·B + bin index
    w = root_w.to(torch.float32)
    idx = (torch.arange(F, device=dev)[:, None] * B
           + binsT.to(torch.int64)).reshape(-1)
    src = torch.stack([(grad * w).expand(F, N).reshape(-1),
                       w.expand(F, N).reshape(-1)], dim=-1)
    lib_ms = event_ms(lambda: torch.zeros((F * B, 2), device=dev).index_add_(
        0, idx, src), 10)
    out["root_bound"] = bound(nbytes(binsT, grad, root_w, out["root"][0]),
                              2 * F * int(root_w.sum()))
    out["root_library"] = lib_ms
    print(f"  histogram root: index_add_ over the flat f*B + bin index "
          f"{lib_ms:.4f} ms; bound {out['root_bound'][0]:.4f} ms "
          f"({out['root_bound'][1]})")
    del idx, src
    out["root_host_us"] = host_us(lambda: H.histogram(binsT, grad, root_w, B),
                                  200)
    print(f"  histogram root: host time of a call (enqueue, no sync) "
          f"{out['root_host_us']:.1f} us")
    fm = data.feat_mask
    scans = {}
    for cn, h in ((1, out["root"][0][None]),
                  (2, torch.stack([out["root"][0], out["child"][0]]))):
        fmc = fm.expand(cn, F)
        scans[cn] = scan_times(h, fmc, f"[{cn}, {F}, {B}, 2]",
                               pair=None if cn == 1 else tuple(
                                   x[None] for x in (out["root"][0],
                                                     out["child"][0])))
    # inclusive prefix sums of both channels and the gain, ~10 operations a
    # (node, feature, bin) of an unmasked row; its bytes read once and the
    # best (gain, feature, bin, ok) of each node written
    scans["bound"] = scan_bound(h, fm.expand(2, F))
    return out, scans


def scan_bound(h, fmask) -> tuple:
    """The split scan's bound on ``h [Cn, F, B, 2]`` under ``fmask``: the
    unmasked rows read once (masked ones are never read), the mask, and 13
    bytes a node out; ~10 operations a bin of an unmasked row."""
    rows = int(fmask.sum())
    row_bytes = h.shape[2] * 2 * 4
    return bound(rows * row_bytes + fmask.shape[0] * fmask.shape[1]
                 + 13 * h.shape[0], 10 * rows * h.shape[2])


def scan_times(h, fmask, what: str, pair=None) -> tuple:
    """Split scan on ``h [Cn, F, B, 2]`` (or the ``pair`` whose nodes it
    stacks) against the plain version: gains to rtol 1e-5 on these float
    histograms, every output exactly on their integer-valued rounding, two
    launches and the pair form identical. Returns (max_abs_err, the
    kernel's own device ms — CUDA events around 20 back-to-back launches
    of the bare ctypes call, divided by 20 —, the plain version's ms, the
    wrapper's ms by CUDA events, its host µs a call)."""
    from ranklib_tpu_torch.ops import split_scan as SS

    arg = h if pair is None else pair
    got = SS.best_splits(arg, 1.0, fmask)
    want = SS.best_splits_plain(h, 1.0, fmask)
    again = SS.best_splits(arg, 1.0, fmask)
    torch.cuda.synchronize()
    fin = torch.isfinite(want[0])
    check(torch.equal(got[3], want[3]), f"split scan {what}: ok flags differ")
    check(torch.allclose(got[0][fin], want[0][fin], rtol=1e-5, atol=0.0),
          f"split-scan gains differ at {what}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"split scan {what}: two launches differ")
    err = float((got[0][fin] - want[0][fin]).abs().max()) if fin.any() \
        else 0.0
    ints = h.round()
    iarg = ints if pair is None else tuple(p.round() for p in pair)
    for a, b in zip(SS.best_splits(iarg, 1.0, fmask),
                    SS.best_splits_plain(ints, 1.0, fmask)):
        check(torch.equal(a, b), f"split scan {what}: not exact on an "
                                 f"integer-valued histogram")
    if pair is not None:
        check(all(torch.equal(a, b) for a, b in
                  zip(got, SS.best_splits(h, 1.0, fmask))),
              f"split scan {what}: pair and stacked forms differ")
    args, _ = SS.launch_args(arg, 1.0, fmask)
    fn = SS._kernels().split_scan
    check(fn(*args) == 0, f"split scan {what}: launch failed")

    def alone():
        for _ in range(20):
            fn(*args)

    ms = event_ms(alone, 20) / 20
    plain_ms = event_ms(lambda: SS.best_splits_plain(h, 1.0, fmask), 10)
    route_ms = event_ms(lambda: SS.best_splits(arg, 1.0, fmask), 50)
    host = host_us(lambda: SS.best_splits(arg, 1.0, fmask), 200)
    print(f"  split scan {what}{' as a pair' if pair else ''}: kernel "
          f"{ms:.5f} ms (device, 20 launches) vs plain {plain_ms:.4f} ms; "
          f"the wrapper {route_ms:.5f} ms by events, {host:.1f} us of host "
          f"time a call; max_abs_err {err:.3e}; exact on integer values")
    return err, ms, plain_ms, route_ms, host


def tree_children_times(binsT, grad, dw, arr, B) -> float:
    """The histogram kernel on the nodes one grown tree really built: the
    root and the right child of each split but the last (slot 2k + 2 of
    iteration k, as grow_tree builds them), replayed from the tree's
    splits. Device ms each (CUDA events, median of 10) and summed per
    grow_tree; the first child is held to the plain version."""
    from ranklib_tpu_torch.ops import histogram as H

    assign = torch.zeros(binsT.shape[1], dtype=torch.int32,
                         device=binsT.device)
    times = [event_ms(lambda: H.histogram(binsT, grad, dw, B), 10)]
    weighted = []
    for k in range(N_LEAVES - 1):
        parent = torch.nonzero(arr.left == 2 * k + 1).flatten()
        if parent.numel() == 0:
            break
        p = int(parent[0])
        go_left = binsT[int(arr.feature[p])].to(torch.int32) <= arr.bin[p]
        in_node = assign == p
        w_r = dw * (in_node & ~go_left)
        if k < N_LEAVES - 2:                    # the peeled last split builds none
            if k == 0:
                got = H.histogram(binsT, grad, w_r, B)
                want = H.histogram_plain(binsT, grad, w_r, B)
                torch.cuda.synchronize()
                check(torch.equal(got[..., 1], want[..., 1])
                      and torch.allclose(got[..., 0], want[..., 0],
                                         **HIST_TOL),
                      "histogram differs from plain on a real child")
            times.append(event_ms(lambda: H.histogram(binsT, grad, w_r, B),
                                  10))
            weighted.append(int(w_r.count_nonzero()))
        assign = torch.where(in_node, torch.where(go_left, 2 * k + 1,
                                                  2 * k + 2),
                             assign).to(torch.int32)
    check(torch.equal(assign, arr.node_of_doc),
          "the replayed splits do not reproduce the tree's leaves")
    total = sum(times)
    print(f"  histogram on one grown tree's nodes: root {times[0]:.4f} ms; "
          f"{len(times) - 1} right children "
          + ", ".join(f"{t:.4f}" for t in times[1:])
          + f" ms ({', '.join(map(str, weighted))} weighted docs); summed "
          f"per grow_tree {total:.4f} ms")
    return total


def round_breakdown(fit, dev) -> dict:
    """Where a full-width round's time goes: fit B's round, and each of
    its parts run alone from the same functions (synchronised wall ms,
    median), plus the device-busy share of one profiled round."""
    from ranklib_tpu_torch.gbdt.grow import grow_tree, leaf_outputs
    from ranklib_tpu_torch.gbdt.lambdas import lambda_fn
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import lambda_kernel as LK
    from ranklib_tpu_torch.ops import split_scan as SS

    scorer = create_scorer("NDCG@10")
    ranker = LambdaMART(n_trees=FIT_TREES, n_leaves=N_LEAVES, early_stop=0)
    step, state, data, thr = ranker.prepare_fit(fit["train"], scorer,
                                                fit["vali"], dev)
    B = thr.shape[1]
    M = 2 * N_LEAVES - 1
    state = step(state, 0, data)                  # warm, scores non-zero
    scores = state.scores
    fn = lambda_fn(scorer)

    def lambdas():
        return LK.chunk_lambdas(fn, data.tb, data.tb_scale, scores,
                                data.tb_inv)[0]

    lam = lambdas()
    w = lam.abs() + 0.5
    arr = grow_tree(data.binned_T, lam, n_bins=B, n_leaves=N_LEAVES,
                    doc_mask=data.doc_mask, feature_mask=data.feat_mask)
    out = leaf_outputs(arr.node_of_doc, lam, w, M, True, data.doc_mask)
    tree_children_times(data.binned_T, lam, data.doc_mask.to(torch.float32),
                        arr, B)
    child = data.doc_mask & (arr.node_of_doc == arr.node_of_doc[0])
    h1 = H.histogram(data.binned_T, lam, data.doc_mask, B)[None]
    fm1, fm2 = data.feat_mask[None], data.feat_mask.expand(2, -1)
    vb = data.vbinned

    def traverse():
        node = torch.zeros(vb.shape[0], dtype=torch.int64, device=dev)
        for _ in range(N_LEAVES):
            f = arr.feature[node].clamp(min=0).long()
            nxt = torch.where(vb.gather(1, f[:, None])[:, 0].to(torch.int32)
                              <= arr.bin[node], arr.left[node],
                              arr.right[node]).long()
            node = torch.where(arr.is_leaf[node], node, nxt)
        return node

    def metric(buckets, sc):
        return sum(scorer.score_from_scores(lab, sc[didx], msk).sum()
                   for lab, msk, didx in buckets)

    parts = {
        "round (fit B)": wall_ms(lambda: step(state, 1, data), 5),
        "lambdas": wall_ms(lambdas, 5),
        "grow_tree": wall_ms(lambda: grow_tree(
            data.binned_T, lam, n_bins=B, n_leaves=N_LEAVES,
            doc_mask=data.doc_mask, feature_mask=data.feat_mask), 5),
        "  histogram root": wall_ms(lambda: H.histogram(
            data.binned_T, lam, data.doc_mask, B), 10),
        "  histogram child": wall_ms(lambda: H.histogram(
            data.binned_T, lam, child, B), 10),
        "  scan [1]": wall_ms(lambda: SS.best_splits(h1, 1.0, fm1), 10),
        "  scan [2]": wall_ms(lambda: SS.best_splits((h1, h1), 1.0, fm2),
                              10),
        "leaf_outputs": wall_ms(lambda: leaf_outputs(
            arr.node_of_doc, lam, w, M, True, data.doc_mask), 10),
        "score update": wall_ms(lambda: scores[:-1] + 0.1 * out.index_select(
            0, arr.node_of_doc), 10),
        "validation traversal": wall_ms(traverse, 10),
        "train metric": wall_ms(lambda: metric(data.tb, scores), 5),
        "validation metric": wall_ms(lambda: metric(data.vb, state.vscores),
                                     5),
    }
    hist = (parts["  histogram root"]
            + (N_LEAVES - 2) * parts["  histogram child"])
    scan = parts["  scan [1]"] + (N_LEAVES - 2) * parts["  scan [2]"]
    parts["  growth bookkeeping (grow_tree − histograms − scans)"] = (
        parts["grow_tree"] - hist - scan)
    for k, v in parts.items():
        print(f"  {k}: {v:.3f} ms")

    profiled("round", lambda: step(state, 2, data))
    return parts


def profiled(what: str, fn) -> None:
    """Device-busy share of one call of fn: kernel time over its wall,
    and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        print(f"  profiled {what}: wall {wall:.3f} ms, device time not "
              f"measured (the profiler saw no kernels)")
        return
    print(f"  profiled {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%), {sum(e.count for e in kernels)} "
          f"kernels; top device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{e.key[:90]}")


def hist_multi_small_checks(dev, group: int) -> float:
    """Multi-bag histogram kernel vs plain: id types, odd B with ids >= B,
    an all-zero bag, multiplicities up to 3, C up to the RF group size."""
    from ranklib_tpu_torch.ops import histogram as H

    rng = np.random.default_rng(19)
    worst = 0.0
    for N, F, B, C in [(300, 6, 8, 1), (1024, 17, 128, 3), (700, 9, 11, 8),
                       (5000, 13, 256, group), (1, 3, 5, 3)]:
        grads = torch.from_numpy(
            rng.normal(size=(C, N)).astype(np.float32)).to(dev)
        w = rng.integers(0, 4, (C, N)).astype(np.float32)
        w[C // 2] = 0.0                              # a bag that weighs nothing
        wt = torch.from_numpy(w).to(dev)
        for dt, top in ((torch.uint8, 256), (torch.int16, 32767),
                        (torch.int32, 1 << 30)):
            ids = rng.integers(0, min(B + 3, top), size=(F, N))
            binsT = torch.from_numpy(ids).to(dt).contiguous().to(dev)
            got = H.histogram_multi(binsT, grads, wt, B)
            again = H.histogram_multi(binsT, grads, wt, B)
            want = H.histogram_multi_plain(binsT, grads, wt, B)
            torch.cuda.synchronize()
            what = f"multi-bag histogram ({N}, {F}, {B}, C={C}, {dt})"
            check(got.shape == want.shape == (C, F, B, 2), f"{what}: shape")
            check(torch.equal(got[..., 1], want[..., 1]),
                  f"{what}: counts differ")
            check(torch.allclose(got[..., 0], want[..., 0], **HIST_TOL),
                  f"{what}: sums differ")
            check(torch.equal(got, again), f"{what}: not reproducible")
            check(not got[C // 2].any(), f"{what}: the zero bag is not 0")
            worst = max(worst, float((got - want).abs().max()))
        print(f"  multi-bag histogram ({N}, {F}, {B}, C={C}) x "
              f"uint8/int16/int32: ok")
    print(f"  multi-bag histogram small cases: max_abs_err={worst:.3e}, "
          f"counts exact, bit-reproducible")
    return worst


def widen_grid(ens, n_feats: int, n_thr: int, n_nodes: int):
    """Move the first ``n_nodes`` splits of a fresh ensemble onto features
    0..n_feats-1 with thresholds from an ``n_thr``-point grid, so a
    feature carries more than 256 thresholds (the f32 route)."""
    pool = np.linspace(-3.0, 3.0, n_thr).astype(np.float32)
    i = 0
    for t in ens.trees:
        for n in np.flatnonzero(~t.is_leaf):
            if i < n_nodes:
                t.feature[n] = i % n_feats
                t.threshold[n] = pool[(i // n_feats) % n_thr]
            i += 1
    return ens


def traversal(ens, X):
    """The plain f32 pointer traversal of ``ens`` on device features."""
    from ranklib_tpu_torch.gbdt.ensemble import _ensemble_eval

    return _ensemble_eval(X, *[torch.from_numpy(a).to(X.device)
                               if isinstance(a, np.ndarray) else a
                               for a in ens._pack()])


def full_small_checks(dev) -> float:
    """f32 forest route: kernel vs plain (bit-identical) and vs the f32
    traversal, on hostile inputs and models."""
    from ranklib_tpu_torch.gbdt.ensemble import Tree
    from ranklib_tpu_torch.ops import forest_eval as fe

    extreme = np.array([FMAX, 3.2e38, 3.0e38, -3.1e38, -FMAX], np.float32)
    worst = 0.0

    def case(name, n_trees, n_leaves, F, N, seed, wide=0, far=False,
             lone_leaf=False, heap=False):
        nonlocal worst
        rng = np.random.default_rng(seed)
        ens = (balanced_ensemble if heap else synthetic_ensemble)(
            n_trees, n_leaves, F, rng)
        if wide:                        # `wide` thresholds on feature 0
            widen_grid(ens, 1, wide, wide)
        if far:            # some thresholds past the TPU kernel's clamp
            for i, t in enumerate(ens.trees):
                for j, n in enumerate(np.flatnonzero(~t.is_leaf)[::4]):
                    t.threshold[n] = extreme[(i + j) % len(extreme)]
        if lone_leaf:
            ens.add(Tree([0], [0.0], [-1], [-1], [True], [0.75]), 0.5)
        X = rng.normal(size=(N, F)).astype(np.float32)
        thrs = np.concatenate([t.threshold[~t.is_leaf] for t in ens.trees])
        flat = X.reshape(-1)
        pick = rng.integers(0, len(thrs), size=flat.size // 3)
        flat[: pick.size] = thrs[pick]               # docs ON thresholds
        if N > 12:
            X[::13, 1 % F] = np.nan
            X[3, 0], X[4, 0] = -np.inf, np.inf
            X[6:12, :] = np.array([FMAX, -FMAX, 3.1e38, -3.05e38, 3.3e38,
                                   1e38], np.float32)[:, None]
        route = ens.serving_route(F, "cuda")[0]
        pack = ens.full_pack(F, dev)
        Xd = torch.from_numpy(X).to(dev)
        got = fe.forest_eval_full(Xd, pack)
        again = fe.forest_eval_full(Xd, pack)
        plain = fe.forest_eval_full_plain(Xd, *pack.matmul_operands(),
                                          tree_chunk=pack.tree_chunk)
        torch.cuda.synchronize()
        print(f" case {name}: {n_trees} trees x {n_leaves} leaves, F={F}, "
              f"N={N}, {ens._bins_grid_meta()[1]} thresholds on a feature, "
              f"route {route}")
        check(torch.equal(got, plain), f"f32 kernel {name}: not bit-equal "
                                       f"to its plain version")
        check(torch.equal(got, again), f"f32 kernel {name}: not reproducible")
        worst = max(worst, max_err(got, traversal(ens, Xd),
                                   "f32 kernel vs f32 traversal"))
        return route

    check(case("odd", 23, 7, 13, 257, 11) == "bins", "odd case route")
    check(case("wide-grid", 60, 7, 13, 300, 5, wide=300) == "f32",
          "a 300-threshold model did not take the f32 route")
    check(case("far-thresholds", 60, 8, 9, 300, 17, wide=420, far=True)
          == "f32", "the far-threshold model did not take the f32 route")
    check(case("wide-input", 20, 6, fe.MAX_FEATURES + 9, 300, 4) == "f32",
          "an input wider than MAX_FEATURES did not take the f32 route")
    case("one-doc", 7, 3, 5, 1, 3)
    check(case("one-leaf-tree", 60, 7, 13, 257, 12, wide=300, lone_leaf=True)
          == "f32", "the one-leaf case did not take the f32 route")
    # chunks of 25 x 149 split records, too large to stage: the walk
    # through the read-only cache
    case("big-trees", 30, 150, 40, 300, 9, heap=True)
    return worst


@contextlib.contextmanager
def timed_group_steps(times: list):
    """Time each group step of every RF fit inside the block (synchronised
    wall ms per ``group_step`` call); the fits are otherwise the users'
    ``fit``."""
    from ranklib_tpu_torch.models import rf as RF

    orig = RF.group_step

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    RF.group_step = timed
    try:
        yield
    finally:
        RF.group_step = orig


def silently(fn, *args, **kw):
    """Run fn with -silent in force (an RF fit then skips the per-bag
    train metric, which scores every bag's ensemble)."""
    from ranklib_tpu_torch.utils.logging import set_silent

    set_silent(True)
    try:
        return fn(*args, **kw)
    finally:
        set_silent(False)


def rf_training_phase(dev, train, group: int) -> dict:
    """RF at the training width: the fit with its counters, a second fit,
    the forest's quality, and one group step with no host sync."""
    from ranklib_tpu_torch.gbdt.boost import upload_bins
    from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
    from ranklib_tpu_torch.models import rf as RF
    from ranklib_tpu_torch.models.gbdt import flatten_binned, pad_binned
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import split_scan as SS

    scorer = create_scorer("NDCG@10")
    feats, labels, _, thr, _, N, F = flatten_binned(train, 256)
    binned, labels_pad, Npad = pad_binned(feats, None, thr, labels, N)
    B = thr.shape[1]
    check(RF.bag_group_size(2 * RF_LEAVES - 1, F, B, Npad, RF_BAGS, dev)
          == group and RF_BAGS >= group, "the RF group size moved")
    n_groups = -(-RF_BAGS // group)
    hp = dict(n_bags=RF_BAGS, n_leaves=RF_LEAVES, n_trees=1,
              feature_sampling_rate=0.3, sub_sampling_rate=1.0)
    cap = RF.bag_group_size(2 * RF_LEAVES - 1, F, B, Npad, 1 << 30, dev)
    print(f"RF: {RF_BAGS} bags x 1 tree x {RF_LEAVES} leaves, B={B}; "
          f"{n_groups} group(s) of up to {group} bags (the card's memory "
          f"takes {cap} a group)")
    steps = []
    rf = RF.RFRanker(**hp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    H.histogram_multi.launches = 0
    SS.best_splits.launches = 0
    H.histogram.launches = 0
    t0 = time.perf_counter()
    with timed_group_steps(steps):
        silently(rf.fit, train, scorer, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"histogram_multi": H.histogram_multi.launches,
                "split_scan": SS.best_splits.launches,
                "histogram": H.histogram.launches}
    peak = torch.cuda.max_memory_allocated(dev)
    want = n_groups * (RF_LEAVES - 1)
    print(f"  fit: {wall:.3f} s wall ({1e3 * wall / RF_BAGS:.3f} ms a bag); "
          f"group steps {', '.join(f'{t:.3f}' for t in steps)} ms "
          f"({max(steps) / group:.3f} ms a bag in a full group); launches "
          f"{launches} (want {want} multi-bag and scan, 0 single); peak "
          f"device memory {peak / 2**30:.2f} GiB")
    check(launches["histogram_multi"] == want
          and launches["split_scan"] == want, "RF launch counts are off")
    check(launches["histogram"] == 0,
          "-rtype 0 launched the single-bag histogram")
    check(len(rf.ensembles) == RF_BAGS
          and all(len(e) == 1 for e in rf.ensembles), "wrong number of trees")
    leaves = np.mean([e.trees[0].is_leaf.sum() for e in rf.ensembles])
    m, _ = score_dataset(scorer, train, rf.eval_dataset(train, dev), dev)
    base, _ = score_dataset(scorer, train, [np.zeros(q.n, np.float32)
                                            for q in train.queries], dev)
    print(f"  {leaves:.1f} leaves a tree on average; train NDCG@10 of the "
          f"forest {m:.4f} (file order {base:.4f})")
    check(np.isfinite(m) and m > base + 0.05,
          "the forest does not rank better than file order")

    again = RF.RFRanker(**hp)
    silently(again.fit, train, scorer, device=dev)
    check(again.model_str() == rf.model_str(),
          "two RF fits of the same data gave different models")
    print("  a second fit gave the same model text (deterministic)")

    binned_T = upload_bins(np.ascontiguousarray(binned.T), dev)
    labels_d = torch.from_numpy(labels_pad).to(dev)
    rng = np.random.default_rng(12)
    w = rng.poisson(1.0, (group, Npad)).astype(np.float32)
    w[:, N:] = 0.0
    doc_w = torch.from_numpy(w).to(dev)
    fm = rng.random((group, F)) < 0.3
    fm[:, 0] = True
    fmask = torch.from_numpy(fm).to(dev)
    scores = torch.zeros((group, Npad), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new_scores, _ = RF.group_step(scores, doc_w, fmask, binned_T,
                                      labels_d, B, RF_LEAVES, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(new_scores).all()), "sync-free group step: NaN")
    print("  one group step ran under set_sync_debug_mode('error'): no host "
          "sync")
    profiled("group step", lambda: RF.group_step(
        scores, doc_w, fmask, binned_T, labels_d, B, RF_LEAVES, 0.1))
    return {"launches": launches, "peak": peak, "wall": wall, "steps": steps,
            "binned_T": binned_T, "grads": labels_d[None] - scores,
            "doc_w": doc_w, "fmask": fmask}


def rf_card_vs_cpu(dev) -> None:
    """4 bags x 8 leaves on 200 queries, plain versions on the CPU vs
    kernels: -rtype 0 (multi-bag histogram) and -rtype 6 (per-bag
    LambdaMART, the single histogram)."""
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models import rf as RF
    from ranklib_tpu_torch.ops import histogram as H

    ds = synth_queries(200, N_FEATURES, seed=5, w_seed=11)
    scorer = create_scorer("NDCG@10")
    for rtype, n_trees in ((0, 1), (6, 2)):
        fits = []
        for d in (torch.device("cpu"), dev):
            r = RF.RFRanker(n_bags=4, n_leaves=8, n_trees=n_trees,
                            ranker_type=rtype)
            H.histogram.launches = H.histogram_multi.launches = 0
            silently(r.fit, ds, scorer, device=d)
            fits.append(r)
        launches = (H.histogram_multi.launches, H.histogram.launches)
        pairs = [(a, b) for ea, eb in zip(fits[0].ensembles,
                                          fits[1].ensembles)
                 for a, b in zip(ea.trees, eb.trees)]
        same = [all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
                    ("feature", "threshold", "left", "right", "is_leaf"))
                for a, b in pairs]
        diff = max(float(np.abs(a.output - b.output).max())
                   for (a, b), ok in zip(pairs, same) if ok)
        print(f"  -rtype {rtype}: {sum(same)} of {len(same)} trees "
              f"identical card vs CPU; leaf outputs differ by at most "
              f"{diff:.2e}; launches on the card (multi-bag, single) "
              f"{launches}")
        firsts = same[::n_trees]
        check(all(same) if rtype == 0 else all(firsts),
              f"-rtype {rtype}: trees differ between the card and the CPU")
        check(launches[0] > 0 if rtype == 0 else launches[1] > 0,
              f"-rtype {rtype} did not launch its histogram kernel")


def rf_kernel_times(rf) -> dict:
    """Multi-bag histogram kernel vs plain at the RF group's width: the
    root (bag multiplicities) and a child (~10% of them)."""
    from ranklib_tpu_torch.ops import histogram as H

    binned_T, grads, doc_w = rf["binned_T"], rf["grads"], rf["doc_w"]
    keep = np.random.default_rng(14).random(tuple(doc_w.shape)) < 0.1
    child = doc_w * torch.from_numpy(keep).to(doc_w.device)
    C, N = doc_w.shape
    F = binned_T.shape[0]
    out = {}
    for name, w in (("root", doc_w), ("child", child)):
        got = H.histogram_multi(binned_T, grads, w, 256)
        want = H.histogram_multi_plain(binned_T, grads, w, 256)
        torch.cuda.synchronize()
        check(torch.equal(got[..., 1], want[..., 1]),
              f"multi-bag histogram counts differ at full width ({name})")
        check(torch.allclose(got[..., 0], want[..., 0], **HIST_TOL),
              f"multi-bag histogram sums differ at full width ({name})")
        check(torch.equal(got, H.histogram_multi(binned_T, grads, w, 256)),
              "multi-bag histogram not reproducible at full width")
        err = float((got - want).abs().max())
        del got, want
        out[name] = (err, event_ms(lambda: H.histogram_multi(
            binned_T, grads, w, 256), 5), event_ms(
            lambda: H.histogram_multi_plain(binned_T, grads, w, 256), 1))
        print(f"  multi-bag histogram {name}: {C} bags x [{F}, {N}] uint8, "
              f"{int(w.count_nonzero())} weighted (bag, doc) pairs: kernel "
              f"{out[name][1]:.4f} ms vs plain {out[name][2]:.4f} ms; "
              f"max_abs_err {err:.3e}")
    out["root_bound"] = bound(
        nbytes(binned_T, grads, doc_w) + C * F * 256 * 2 * 4,
        2 * F * int(doc_w.count_nonzero()))
    # the root's library call: one index_add_ over the flat f·B + bin index
    # of every bag, whose expanded [C, F·N, 2] source must fit the card
    need = 2 * C * F * N * 4 + C * F * 256 * 2 * 4 + F * N * 8
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(binned_T.device)[0]
    out["root_library"] = None
    if free > 1.1 * need:
        dev = binned_T.device
        idx = (torch.arange(F, device=dev)[:, None] * 256
               + binned_T.to(torch.int64)).reshape(-1)
        src = torch.stack([grads * doc_w, doc_w], dim=-1)[:, None].expand(
            C, F, N, 2).reshape(C, F * N, 2)
        out["root_library"] = event_ms(lambda: torch.zeros(
            (C, F * 256, 2), device=dev).index_add_(1, idx, src), 1)
        del idx, src
        torch.cuda.empty_cache()
        print(f"  multi-bag histogram root: index_add_ over the flat f*B + "
              f"bin index of every bag {out['root_library']:.4f} ms")
    else:
        print(f"  multi-bag histogram root: the index_add_ source needs "
              f"{need / 2**30:.1f} GiB, {free / 2**30:.1f} GiB free: not "
              f"timed")
    print(f"  multi-bag histogram root bound {out['root_bound'][0]:.4f} ms "
          f"({out['root_bound'][1]})")
    out["root_host_us"] = host_us(lambda: H.histogram_multi(
        binned_T, grads, doc_w, 256), 20)
    print(f"  multi-bag histogram root: host time of a call (enqueue, no "
          f"sync) {out['root_host_us']:.1f} us")
    out["step_ms"] = forest_children_times(rf)
    return out


def rf_scan_times(rf) -> tuple:
    """The split scan at the Random Forest's width: the group's root
    histograms and a ~10% child's, as the pair growth passes it
    ([2 x bags, 136, 256, 2]), under the bags' feature masks."""
    from ranklib_tpu_torch.ops import histogram as H

    binned_T, grads, doc_w = rf["binned_T"], rf["grads"], rf["doc_w"]
    keep = np.random.default_rng(15).random(tuple(doc_w.shape)) < 0.1
    child_w = doc_w * torch.from_numpy(keep).to(doc_w.device)
    pair = (H.histogram_multi(binned_T, grads, doc_w, 256),
            H.histogram_multi(binned_T, grads, child_w, 256))
    h = torch.cat(pair)
    fm = torch.cat([rf["fmask"], rf["fmask"]])
    res = scan_times(h, fm, f"[{h.shape[0]}, {h.shape[1]}, 256, 2]", pair)
    bnd = scan_bound(h, fm)
    print(f"  split scan at the RF width: bound {bnd[0]:.4f} ms ({bnd[1]}; "
          f"{int(fm.sum())} of {fm.numel()} rows unmasked; all rows "
          f"{nbytes(h) / HBM_BYTES_S * 1e3:.4f} ms)")
    return res + (bnd,)


def forest_children_times(rf) -> float:
    """The multi-bag kernel on the nodes one group step really builds: the
    roots and the right children of every split but the last, each a
    [bags, N] weight matrix replayed from grow_forest's splits on the
    group's bags. Device ms of each launch (CUDA events, one timed launch)
    and their sum per group step; the first child is held to the plain
    version."""
    from ranklib_tpu_torch.gbdt.grow import grow_forest
    from ranklib_tpu_torch.ops import histogram as H

    binned_T, grads, doc_w = rf["binned_T"], rf["grads"], rf["doc_w"]
    arr = grow_forest(binned_T, grads, 256, RF_LEAVES, 1, doc_w, rf["fmask"])
    C, N = doc_w.shape
    cidx = torch.arange(C, device=doc_w.device)
    assign = torch.zeros((C, N), dtype=torch.int32, device=doc_w.device)
    times = [event_ms(lambda: H.histogram_multi(binned_T, grads, doc_w, 256),
                      1)]
    pairs = []
    for k in range(RF_LEAVES - 1):
        hit = arr.left == 2 * k + 1                          # [C, M]
        valid = hit.any(dim=1)
        p = hit.to(torch.int32).argmax(dim=1)                # [C] int64
        f = arr.feature[cidx, p].clamp(min=0).long()
        go_left = (binned_T.index_select(0, f).to(torch.int32)
                   <= arr.bin[cidx, p][:, None])
        in_node = (assign == p[:, None]) & valid[:, None]
        if k < RF_LEAVES - 2:
            w_r = doc_w * (in_node & ~go_left)
            if k == 0:
                got = H.histogram_multi(binned_T, grads, w_r, 256)
                want = H.histogram_multi_plain(binned_T, grads, w_r, 256)
                torch.cuda.synchronize()
                check(torch.equal(got[..., 1], want[..., 1])
                      and torch.allclose(got[..., 0], want[..., 0],
                                         **HIST_TOL),
                      "multi-bag histogram differs from plain on a real "
                      "child")
                del got, want
            times.append(event_ms(lambda: H.histogram_multi(
                binned_T, grads, w_r, 256), 1))
            pairs.append(int(w_r.count_nonzero()))
            del w_r
        assign = torch.where(in_node, torch.where(go_left, 2 * k + 1,
                                                  2 * k + 2),
                             assign).to(torch.int32)
    check(torch.equal(assign, arr.node_of_doc),
          "the replayed splits do not reproduce the forest's leaves")
    total = sum(times)
    kids = times[1:]
    print(f"  multi-bag histogram on one group step's nodes ({C} bags): "
          f"root {times[0]:.4f} ms; {len(kids)} right children "
          f"{min(kids):.4f}-{max(kids):.4f} ms (mean {np.mean(kids):.4f}; "
          f"{pairs[0]} weighted (bag, doc) pairs at the first, {pairs[-1]} "
          f"at the last); summed per group step {total:.4f} ms")
    return total


def full_route_phase(dev, Xh, Xd) -> dict:
    """The f32 route at the serving width with a 1,024-point grid on 8
    features: kernel vs plain and traversal, times, eval_matrix."""
    from ranklib_tpu_torch.ops import forest_eval as fe

    ens = widen_grid(synthetic_ensemble(N_TREES, N_LEAVES, N_FEATURES,
                                        np.random.default_rng(0)),
                     8, 1024, 8192)
    n_thr = ens._bins_grid_meta()[1]
    route = ens.serving_route(N_FEATURES, "cuda")
    print(f"model: {N_TREES} trees x {N_LEAVES} leaves, {n_thr} thresholds "
          f"on a feature; route {route}")
    check(route[0] == "f32" and n_thr > 256, "the model missed the f32 route")
    pack = ens.full_pack(N_FEATURES, dev)
    got = fe.forest_eval_full(Xd, pack)
    plain = fe.forest_eval_full_plain(Xd, *pack.matmul_operands(),
                                      tree_chunk=pack.tree_chunk)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), "f32 kernel not bit-equal to plain at "
                                   "full width")
    err = max_err(got, plain, f"f32 kernel vs plain ({N_DOCS} docs)")
    max_err(got, traversal(ens, Xd), "f32 kernel vs f32 traversal")
    ms = event_ms(lambda: fe.forest_eval_full(Xd, pack), 20)
    plain_ms = event_ms(lambda: fe.forest_eval_full_plain(
        Xd, *pack.matmul_operands(), tree_chunk=pack.tree_chunk), 3)
    max_err(torch.from_numpy(ens.eval_matrix(Xh, dev)), plain.cpu(),
            "eval_matrix (f32 route) vs plain")
    e2e = wall_ms(lambda: ens.eval_matrix(Xh, dev), 3)
    bnd = bound(nbytes(Xd, got) + pack_bytes(pack), walk_ops(ens, Xd))
    # the design the f32 kernel was held against: int16 ids binned on the
    # card against the model's own grid and walked by the bins kernel,
    # exact only while every feature's thresholds fit 16-bit node bins
    alt_pack = ens.forest_pack(N_FEATURES, dev)
    alt = fe.forest_eval_bins(Xd, alt_pack)
    torch.cuda.synchronize()
    check(torch.equal(alt, plain), "int16 ids against the model grid: not "
                                   "bit-equal to the f32 plain version")
    alt_ms = event_ms(lambda: fe.forest_eval_bins(Xd, alt_pack), 20)
    print(f"  device time (CUDA events, median): f32 kernel {ms:.4f} ms vs "
          f"plain {plain_ms:.4f} ms (bound {bnd[0]:.4f} ms, {bnd[1]}); "
          f"int16 ids against the {alt_pack.n_grid}-threshold grid through "
          f"the bins kernel {alt_ms:.4f} ms, bit-equal; eval_matrix wall "
          f"{e2e:.3f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bnd}


def rf_cli(tmp) -> int:
    """-train -ranker 8 then -load -test; -combine of three forests from
    different 5-feature files (each feature splits ~400 times a forest,
    so their union holds more than 256 thresholds on a feature), then
    -load -test -idv of the result through the f32 kernel with every
    counter at 0. Returns its f32 launches."""
    from ranklib_tpu_torch import cli
    from ranklib_tpu_torch.data.letor import read_letor
    from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
    from ranklib_tpu_torch.models.base import load_ranker_file
    from ranklib_tpu_torch.ops import forest_eval as fe
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import split_scan as SS

    train, test = (os.path.join(tmp, f) for f in ("train.txt", "test.txt"))
    model = os.path.join(tmp, "rf.txt")
    rc, out = quiet(cli.main, [
        "-train", train, "-ranker", "8", "-bag", "20", "-leaf",
        str(RF_LEAVES), "-metric2t", "NDCG@10", "-test", test, "-metric2T",
        "NDCG@10", "-save", model])
    check(rc == 0, f"-train -ranker 8 failed:\n{out[-2000:]}")
    bag_lines = [ln for ln in out.splitlines() if ln.startswith("bag ")]
    trained = [ln for ln in out.splitlines() if " on " in ln]
    rc, out = quiet(cli.main, ["-load", model, "-test", test, "-metric2T",
                               "NDCG@10"])
    loaded = [ln for ln in out.splitlines() if " on test data" in ln]
    print(f"  -ranker 8: {len(bag_lines)} bag lines ({bag_lines[-1]}); "
          f"{'; '.join(trained)}; -load: {loaded[0]}")
    check(rc == 0 and len(bag_lines) == 20 and loaded[0] in trained,
          "the loaded forest's test metric differs from training's")

    bags = os.path.join(tmp, "rf_bags")
    os.makedirs(bags)
    for i in range(3):
        path = os.path.join(tmp, f"narrow{i}.txt")
        write_dataset(path, synth_queries(300, 5, seed=30 + i, w_seed=31))
        rc, out = quiet(cli.main, [
            "-train", path, "-ranker", "8", "-bag", "20", "-leaf",
            str(RF_LEAVES), "-frate", "1.0", "-silent", "-save",
            os.path.join(bags, f"rf{i}.txt")])
        check(rc == 0, f"-train -ranker 8 on {path} failed:\n{out[-2000:]}")
    combined = os.path.join(tmp, "combined.txt")
    rc, out = quiet(cli.main, ["-combine", bags, "-o", combined])
    check(rc == 0, f"-combine failed:\n{out[-2000:]}")
    forest = load_ranker_file(combined)
    merged = forest._merged_ensemble()
    n_thr = merged._bins_grid_meta()[1]
    print(f"  -combine: {len(forest.ensembles)} bags from 3 files, "
          f"{n_thr} thresholds on a feature, route "
          f"{merged.serving_route(5, 'cuda')}")
    check(len(forest.ensembles) == 60 and n_thr > 256
          and merged.serving_route(5, "cuda")[0] == "f32",
          "the combined forest does not need the f32 route")
    narrow_test = os.path.join(tmp, "narrow_test.txt")
    write_dataset(narrow_test, synth_queries(100, 5, seed=39, w_seed=31))
    idv = os.path.join(tmp, "combined.idv")
    for counted in (fe.forest_eval_frombins, fe.forest_eval_bins,
                    fe.forest_eval_full, H.histogram, H.histogram_multi,
                    SS.best_splits):
        counted.launches = 0
    rc, out = quiet(cli.main, ["-load", combined, "-test", narrow_test,
                               "-metric2T", "NDCG@10", "-idv", idv])
    torch.cuda.synchronize()
    launches = fe.forest_eval_full.launches
    check(rc == 0 and launches > 0,
          "-load -test of the combined forest did not run the f32 kernel")
    ds, _ = quiet(read_letor, narrow_test)
    cpu = torch.device("cpu")
    m, _ = score_dataset(create_scorer("NDCG@10"), ds,
                         forest.eval_dataset(ds, cpu), cpu)
    got = [ln for ln in out.splitlines() if " on test data" in ln][-1]
    print(f"  -load -test of the combined forest: {got} (plain version on "
          f"the CPU: {m:.4f}); f32 launches {launches}")
    check(got == f"NDCG@10 on test data: {m:.4f}",
          "the combined forest's CLI metric differs from the plain version")
    with open(idv) as f:
        check(len(f.read().splitlines()) == 101,
              "idv file should hold 100 queries + all")
    return launches


def bare_ms(fn, args, reps: int = 20) -> float:
    """A kernel's own device time: CUDA events around ``reps`` back-to-back
    launches of its bare ctypes call (no wrapper, no allocation), divided
    by ``reps``; median of 20 such runs."""
    check(fn(*args) == 0, "bare launch failed")

    def alone():
        for _ in range(reps):
            fn(*args)

    return event_ms(alone, 20) / reps


def lambda_bound(rd) -> tuple:
    """The fused round's bound on these inputs: labels and scores read and
    lam and w written once a document, the per-query factors and the
    discount table read once; 13 operations a (winner, loser) pair (the
    pair terms and the two sums on each side) and one compare an ordered
    (document, document) pair of a query (the rank)."""
    labels = rd.labels.cpu().numpy()
    qptr = rd.qptr.cpu().numpy()
    pairs = compares = 0
    for q in range(len(qptr) - 1):
        L = labels[qptr[q]:qptr[q + 1]]
        pairs += int((L[:, None] > L[None, :]).sum())
        compares += L.size * L.size
    npad = labels.size
    return bound(16 * npad + nbytes(rd.qptr, rd.order, rd.qfac, rd.keff,
                                    rd.disc),
                 13 * pairs + compares), pairs


def fused_lambda_phase(dev, fit, tmp, smi) -> dict:
    """RANKLIB_TPU_FUSED_LAMBDA=1 at the training shape: a 50-tree fit with
    its counters at 0 (one lambda launch a round), the kernel vs plain on
    the fit's scores, its own device time (bare launches), the lambda
    phase alone against the sort-free path, a sync-free round, card vs CPU
    and the training CLI."""
    from ranklib_tpu_torch.gbdt import lambdas as PL
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import lambda_kernel as LK
    from ranklib_tpu_torch.ops import split_scan as SS

    scorer = create_scorer("NDCG@10")
    train = fit["train"]
    hp = dict(n_trees=FIT_TREES, n_leaves=N_LEAVES, learning_rate=0.1,
              n_threshold=256, min_leaf_support=1, early_stop=0)
    # a sort-free fit next to the fused one, for rounds timed alike
    times_sf = []
    with timed_rounds(times_sf):
        quiet(LambdaMART(**hp).fit, train, scorer, device=dev)
    ms_sf = float(np.median(times_sf))
    os.environ[FUSED_FLAG] = "1"
    try:
        check(LK.supports_fused(scorer), "the flag did not take the fused "
                                         "route")
        times = []
        r = LambdaMART(**hp)
        torch.cuda.synchronize()
        LK.lambda_round.launches = 0
        H.histogram.launches = SS.best_splits.launches = 0
        with timed_rounds(times):
            quiet(r.fit, train, scorer, device=dev)
        torch.cuda.synchronize()
        launches = {"lambda_pairs": LK.lambda_round.launches,
                    "histogram": H.histogram.launches,
                    "split_scan": SS.best_splits.launches}
        want = {"lambda_pairs": FIT_TREES,
                "histogram": FIT_TREES * (N_LEAVES - 1),
                "split_scan": FIT_TREES * (N_LEAVES - 1)}
        print(f"fused fit: {FIT_TREES} trees; launches {launches} (want "
              f"{want}: one lambda launch a round)")
        check(launches == want, "the fused fit's launch counts are off")
        tm = r.fit_state.train_m[:FIT_TREES].cpu().numpy()
        print(f"  train NDCG@10 round 1 {tm[0]:.4f} -> round {FIT_TREES} "
              f"{tm[-1]:.4f} (sort-free fit A: "
              f"{float(fit['train_m'][0]):.4f} -> "
              f"{float(fit['train_m'][-1]):.4f})")
        check(bool(np.isfinite(tm).all()) and tm[-1] > tm[0],
              "train NDCG@10 did not rise over the fused fit")
        ms_round = float(np.median(times))
        print(f"  median wall ms per round: fused {ms_round:.3f} vs "
              f"sort-free {ms_sf:.3f} just before it (fit A in phase 5: "
              f"{fit['ms_a']:.3f})  [{smi}]")

        step, state, data, _ = r.prepare_fit(train, scorer, None, dev)
        rd = data.fused
        check(rd is not None, "the fit under the flag built no fused data")
        scores = r.fit_state.scores
        got = LK.lambda_round(rd, scores)
        again = LK.lambda_round(rd, scores)
        want_ = LK.lambda_round_plain(rd, scores)
        torch.cuda.synchronize()
        err = 0.0
        n_real = int(rd.qptr[-1])
        for g, a, w in zip(got, again, want_):
            check(torch.equal(g, a), "lambda kernel not reproducible at the "
                                     "training shape")
            check(torch.allclose(g, w, **LAMBDA_TOL),
                  "lambda kernel and plain version disagree at the training "
                  "shape")
            check(not g[n_real:].any(), "lambda kernel: pad documents not 0")
            err = max(err, float((g - w).abs().max()))
        args, keep = LK.launch_args(rd, scores)
        ms = bare_ms(LK._kernels().lambda_pairs, args)
        del keep
        route_ms = event_ms(lambda: LK.lambda_round(rd, scores), 50)
        host = host_us(lambda: LK.lambda_round(rd, scores), 200)
        plain_ms = event_ms(lambda: LK.lambda_round_plain(rd, scores), 5)
        bnd, pairs = lambda_bound(rd)
        print(f"  kernel vs plain over {rd.qptr.shape[0] - 1} queries "
              f"(widest {rd.max_docs} docs): max_abs_err {err:.3e}, two "
              f"launches bit-identical; a round's lambdas: kernel {ms:.5f} "
              f"ms (device, 20 bare launches; target <= 0.05: "
              f"{'met' if ms <= 0.05 else 'MISSED'}), the wrapper "
              f"{route_ms:.5f} ms by events and {host:.1f} us of host time "
              f"a call, plain {plain_ms:.4f} ms ({pairs} pairs, bound "
              f"{bnd[0]:.5f} ms, {bnd[1]})  [{smi}]")

        def sort_free():
            return LK.chunk_lambdas(
                lambda lab, sc, msk, scl: PL.lambda_weights_nosort(
                    scorer, lab, sc, msk, scl),
                data.tb, data.tb_scale, scores, data.tb_inv)

        fused_l, fused_w = LK.lambda_round(rd, scores)
        sf_l, sf_w = sort_free()
        diff = float((fused_l - sf_l).abs().max())
        check(torch.allclose(fused_l, sf_l, atol=1e-4, rtol=1e-4)
              and torch.allclose(fused_w, sf_w, atol=1e-4, rtol=1e-4),
              "fused and sort-free lambdas disagree")
        phase = {"fused wall": wall_ms(lambda: LK.lambda_round(rd, scores),
                                       10),
                 "fused device": event_ms(lambda: LK.lambda_round(rd, scores),
                                          10),
                 "sort-free wall": wall_ms(sort_free, 10),
                 "sort-free device": event_ms(sort_free, 10)}
        print(f"  the lambda phase alone (ms, median; fused vs sort-free "
              f"lambdas differ by {diff:.3e}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in phase.items())
              + f"; fused wall target <= 0.5: "
              f"{'met' if phase['fused wall'] <= 0.5 else 'MISSED'}  "
              f"[{smi}]")

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = step(state, 0, data)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(state.scores).all()), "sync-free fused "
                                                        "round: NaN")
        print("  one fused round ran under set_sync_debug_mode('error'): no "
              "host sync")

        before = LK.lambda_round.launches
        card_vs_cpu(dev)
        check(LK.lambda_round.launches > before,
              "the card's fit under the flag did not launch the lambda "
              "kernel")
        LK.lambda_round.launches = 0
        training_cli(tmp, rankers=(6,))
        torch.cuda.synchronize()
        print(f"  -train -ranker 6 under the flag: "
              f"{LK.lambda_round.launches} lambda launches")
        check(LK.lambda_round.launches > 0,
              "the training CLI under the flag did not launch the lambda "
              "kernel")
    finally:
        os.environ.pop(FUSED_FLAG, None)
    return {"launches": launches["lambda_pairs"], "err": err, "ms": ms,
            "plain_ms": plain_ms, "bound": bnd, "ms_round": ms_round,
            "ms_round_sort_free": ms_sf, "phase": phase,
            "route_ms": route_ms, "host_us": host}


def split_serving_phase(dev, ens, pack, Xh, Xd, plain_b, paths, smi) -> dict:
    """RANKLIB_TPU_SERVE_SPLIT=1 at the serving width: the binning kernel
    and the split route against their plain versions, their times, then
    eval_matrix and the CLI with the counters at 0."""
    from ranklib_tpu_torch import cli
    from ranklib_tpu_torch.ops import forest_eval as fe

    ids_p = fe.device_bins(Xd, pack.grid, pack.n_grid)
    ids_k = fe.device_bins_narrow(Xd, pack)
    torch.cuda.synchronize()
    check(ids_k.dtype == torch.uint8 and torch.equal(ids_k.to(torch.int32),
                                                     ids_p),
          "the binning kernel's ids differ from device_bins at full width")
    split = fe.forest_eval_bins_split(Xd, pack)
    torch.cuda.synchronize()
    check(torch.equal(split, fe.forest_eval_bins(Xd, pack)),
          "the split route is not bit-equal to the bins kernel")
    check(torch.equal(split, plain_b), "the split route is not bit-equal to "
                                       "the plain version")
    err = max_err(split, plain_b, f"split route vs plain ({N_DOCS} docs)")
    XT = Xd.T.contiguous()
    grid_n = pack.grid[:, :pack.n_grid].contiguous()
    ids_b = torch.empty_like(ids_k)
    ms = bare_ms(fe._kernels().forest_bins_only_u8,
                 (Xd.data_ptr(), N_DOCS, N_FEATURES, pack.grid.data_ptr(),
                  int(pack.grid.shape[1]), pack.n_grid, ids_b.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream))
    check(torch.equal(ids_b, ids_k), "the bare binning launches wrote other "
                                     "ids")
    route_ms = event_ms(lambda: fe.device_bins_narrow(Xd, pack), 20)
    host = host_us(lambda: fe.device_bins_narrow(Xd, pack), 200)
    plain_ms = event_ms(lambda: fe.device_bins(Xd, pack.grid, pack.n_grid)
                        .to(torch.uint8), 5)
    lib_ms = event_ms(lambda: torch.searchsorted(grid_n, XT), 20)
    split_ms = event_ms(lambda: fe.forest_eval_bins_split(Xd, pack), 20)
    bnd = bound(nbytes(Xd, ids_k, pack.grid), bin_search_ops(Xd, pack))
    print(f"  binning kernel {ms:.5f} ms (device, 20 bare launches; target "
          f"<= 0.106: {'met' if ms <= 0.106 else 'MISSED'}), the wrapper "
          f"{route_ms:.5f} ms by events and {host:.1f} us of host time a "
          f"call; plain {plain_ms:.4f} ms; torch.searchsorted on X^T "
          f"{lib_ms:.4f} ms (bound {bnd[0]:.4f} ms, {bnd[1]}); split route "
          f"(binning + frombins) {split_ms:.4f} ms by events  [{smi}]")
    del XT, grid_n, ids_b

    os.environ[SPLIT_FLAG] = "1"
    try:
        check(ens.serving_route(N_FEATURES, "cuda")[0] == "bins_split",
              "the flag did not take the split route")
        torch.cuda.synchronize()
        for counted in (fe.device_bins_narrow, fe.forest_eval_frombins,
                        fe.forest_eval_bins):
            counted.launches = 0
        scores = ens.eval_matrix(Xh, dev)
        rc, out = quiet(cli.main, ["-load", paths["model"], "-test",
                                   paths["data"], "-metric2T", "NDCG@10"])
        torch.cuda.synchronize()
        launches = {"bins_only": fe.device_bins_narrow.launches,
                    "frombins": fe.forest_eval_frombins.launches,
                    "bins": fe.forest_eval_bins.launches}
        line = [ln for ln in out.splitlines() if " on test data" in ln]
        print(f"  eval_matrix and -load -test under the flag: launches "
              f"{launches}; {line}")
        check(rc == 0 and line == [f"NDCG@10 on test data: "
                                   f"{paths['ndcg']:.4f}"],
              "the CLI's metric under the split route differs")
        check(launches["bins_only"] > 0 and launches["frombins"] > 0
              and launches["bins"] == 0,
              "the split route did not launch the binning and frombins "
              "kernels")
        check(np.array_equal(scores, plain_b.cpu().numpy()),
              "eval_matrix under the split route differs from the plain "
              "version")
        e2e = wall_ms(lambda: ens.eval_matrix(Xh, dev), 5)
        print(f"  eval_matrix wall under the split route {e2e:.3f} ms  "
              f"[{smi}]")
    finally:
        os.environ.pop(SPLIT_FLAG, None)
    return {"launches": launches["bins_only"], "err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound": bnd,
            "split_ms": split_ms, "e2e": e2e, "route_ms": route_ms,
            "host_us": host}


def pred_phase(dev, ens, Xd, smi) -> dict:
    """The predicate epilogue at the serving width: node tests of the f32
    pack built on the card, uint8 and bf16, against the plain version and
    the f32 route."""
    from ranklib_tpu_torch.ops import forest_eval as fe

    fpack = ens.full_pack(N_FEATURES, dev)
    ops = fpack.matmul_operands()[2:]
    predT = pred_matrix(fpack, Xd)
    pred_bf = predT.to(torch.bfloat16)
    print(f"  node tests [{predT.shape[0]}, {predT.shape[1]}] (uint8 "
          f"{nbytes(predT) / 2**30:.2f} GiB, bf16 "
          f"{nbytes(pred_bf) / 2**30:.2f} GiB); tree_chunk "
          f"{fpack.tree_chunk}, nodes_per_tree {fpack.nodes_per_tree}")
    torch.cuda.synchronize()
    fe.forest_eval_pred.launches = 0
    got = {dt: fe.forest_eval_pred(p, fpack)
           for dt, p in (("uint8", predT), ("bf16", pred_bf))}
    torch.cuda.synchronize()
    launches = fe.forest_eval_pred.launches
    check(launches == 2, "the predicate epilogue was not launched")
    plain = fe.forest_eval_pred_plain(predT, *ops,
                                      tree_chunk=fpack.tree_chunk)
    full = fe.forest_eval_full(Xd, fpack)
    torch.cuda.synchronize()
    for dt, g in got.items():
        check(torch.equal(g, plain), f"predicate epilogue ({dt}) not "
                                     f"bit-equal to plain at full width")
        check(torch.equal(g, full), f"predicate epilogue ({dt}) not "
                                    f"bit-equal to the f32 route")
    err = max_err(got["uint8"], plain, "predicate epilogue vs plain")
    ms = {dt: event_ms(lambda p=p: fe.forest_eval_pred(p, fpack), 10)
          for dt, p in (("uint8", predT), ("bf16", pred_bf))}
    plain_ms = event_ms(lambda: fe.forest_eval_pred_plain(
        predT, *ops, tree_chunk=fpack.tree_chunk), 3)
    # a multiply-add a nonzero of P−Q and a compare a leaf column, per doc
    n_ops = Xd.shape[0] * (2 * int(ops[0].count_nonzero()) + ops[1].numel())
    bnd = {dt: bound(nbytes(p, *ops, got[dt]), n_ops)
           for dt, p in (("uint8", predT), ("bf16", pred_bf))}
    print(f"  device time (CUDA events, median): uint8 {ms['uint8']:.4f} ms "
          f"(bound {bnd['uint8'][0]:.4f}, {bnd['uint8'][1]}), bf16 "
          f"{ms['bf16']:.4f} ms (bound {bnd['bf16'][0]:.4f}, "
          f"{bnd['bf16'][1]}); plain {plain_ms:.4f} ms  [{smi}]")
    del predT, pred_bf
    torch.cuda.empty_cache()
    return {"launches": launches, "err": err, "ms": ms["uint8"],
            "ms_bf16": ms["bf16"], "plain_ms": plain_ms,
            "bound": bnd["uint8"]}


def probe_phase(dev, smi) -> dict:
    """The compiler probes at the reference's shape, with their counters at
    0, and the PyTorch call of each product."""
    from ranklib_tpu_torch.tools import probes as P

    P.dot.launches = P.compare.launches = 0
    res = P.measure(P.PROBE_K, 3, dev)
    torch.cuda.synchronize()
    launches = P.dot.launches + P.compare.launches
    check(P.dot.launches > 0 and P.compare.launches > 0,
          "the probes did not launch their kernels")
    a, b = P.probe_inputs(P.PROBE_K, dev)
    af, bf = a.float(), b.float()
    plain_ms = event_ms(lambda: P.dot_plain(a, b), 3)
    lib = {"int8": event_ms(lambda: torch._int_mm(a, b), 3),
           "f32": event_ms(lambda: torch.matmul(af, bf), 3)}
    got = P.dot(a, b)
    err = float((got - P.dot_plain(a, b)).abs().max())
    check(err == 0.0 and torch.equal(torch._int_mm(a, b), got),
          "the int8 probe differs from its plain version or torch._int_mm")
    ops = 2 * P.PROBE_M * P.PROBE_N * P.PROBE_K
    out_b = P.PROBE_M * P.PROBE_N * 4
    bnd = {"int8": bound(nbytes(a, b) + out_b, ops, P.PEAK_OPS["int8"]),
           "f32": bound(nbytes(af, bf) + out_b, ops, P.PEAK_OPS["f32"])}
    for v in ("f32", "int8"):
        r = res[v]
        print(f"  {v} dot [{P.PROBE_M}, {P.PROBE_K}] x [{P.PROBE_K}, "
              f"{P.PROBE_N}]: {r['ms']:.4f} ms (one call, median of 3), "
              f"{r['tops']:.2f} T(fl)op/s = {100 * r['peak_share']:.2f}% of "
              f"the published {P.PEAK_OPS[v] / 1e12:.0f} T; checksum "
              f"{r['checksum']}; bound {bnd[v][0]:.4f} ms ({bnd[v][1]}); "
              f"PyTorch {lib[v]:.4f} ms  [{smi}]")
    print(f"  f32 kernel / torch.matmul: "
          f"{res['f32']['ms'] / lib['f32']:.3f}; int8 kernel / its bound: "
          f"{res['int8']['ms'] / bnd['int8'][0]:.3f}")
    print(f"  int16 compare: result_sum {res['compare']['sum']:.0f}, "
          f"{res['compare']['ms']:.4f} ms; plain (float64 product) "
          f"{plain_ms:.4f} ms; launches {launches}")
    check(res["compare"]["sum"] == 438.0, "the compare probe's sum moved")
    del a, b, af, bf
    return {"launches": launches, "err": err, "ms": res["int8"]["ms"],
            "plain_ms": plain_ms, "library_ms": lib["int8"],
            "bound": bnd["int8"]}


def hist_bare(binsT, grad, w, B):
    """(fn, args, keep): one bare ctypes launch of the histogram kernel,
    laid out as ``ops.histogram`` lays it out; ``keep`` holds the output
    and scratch alive."""
    from ranklib_tpu_torch.ops import histogram as H

    F, N = binsT.shape
    p = H.plan(F, B, 1, N)
    dev = binsT.device
    out = torch.empty((F, B, 2), dtype=torch.float32, device=dev)
    partial = (torch.empty(p.slices * out.numel(), dtype=torch.float32,
                           device=dev) if p.slices > 1 else out)
    ids = binsT.data_ptr()
    vec = int(ids % 16 == 0 and N * binsT.element_size() % 16 == 0)
    fn = getattr(H._kernels(), f"histogram_{H._TYPES[binsT.dtype]}")
    args = (ids, grad.data_ptr(), w.data_ptr(), N, F, B, p.warp_bins,
            p.ranges, p.slice_len, p.slices, vec, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return fn, args, (out, partial)


def coorascent_phase(dev, train, smi) -> dict:
    """Coordinate Ascent at the training width, RankLib's defaults, with
    TF32 enabled outside the fit: every candidate product must run in full
    f32. The wall per sweep, the peak memory, and one coordinate step
    under ``set_sync_debug_mode("error")``."""
    from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
    from ranklib_tpu_torch.models import coorascent as PCA
    from ranklib_tpu_torch.ops.batched_eval import full_f32_products

    scorer = create_scorer("NDCG@10")
    hp = dict(n_restart=5, n_max_iteration=25, tolerance=0.001,
              max_passes=CA_PASSES)
    modes, sweeps = [], []
    orig = PCA.candidate_metrics

    def watched(*a, **kw):
        modes.append((torch.backends.cuda.matmul.allow_tf32,
                      torch.get_float32_matmul_precision()))
        return orig(*a, **kw)

    ca = PCA.CoorAscent(**hp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    PCA.candidate_metrics = watched
    torch.set_float32_matmul_precision("high")       # TF32 outside the fit
    t0 = time.perf_counter()
    try:
        with timed_steps(PCA.CoorAscent, sweeps):
            _, out = quiet(ca.fit, train, scorer, device=dev)
    finally:
        PCA.candidate_metrics = orig
        torch.set_float32_matmul_precision("highest")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    check(modes and all(m == (False, "highest") for m in modes),
          "a Coordinate Ascent candidate product ran with TF32 enabled")
    passes = [ln.strip() for ln in out.splitlines() if "pass " in ln]
    final = [ln for ln in out.splitlines() if "on training data" in ln]
    print(f"  Coordinate Ascent, -r 5 -i 25 -tolerance 0.001, NDCG@10, "
          f"{len(sweeps)} sweeps (of RankLib's 25): {'; '.join(passes)}")
    print(f"  {final[0]}; {len(modes)} candidate products, each in full "
          f"f32 (TF32 enabled outside the fit)")
    m, _ = score_dataset(scorer, train, ca.eval_dataset(train, dev), dev)
    best = float(final[0].split()[-1])
    print(f"  rescored model: NDCG@10 {m:.6f} (the sweep's {best:.4f})")
    check(np.isfinite(ca.weights).all()
          and abs(np.abs(ca.weights).sum() - 1) < 1e-9,
          "Coordinate Ascent weights not finite or not L1-normalized")
    check(abs(m - best) <= 1e-3, "the rescored model disagrees with the "
                                 "sweep's metric")
    check("(5/5 restarts improving)" in passes[0],
          "the first sweep improved no restart")
    sweep, w, cur, order_T, buckets = ca.prepare_fit(train, scorer, dev)
    rows = max(b[0].shape[0] * b[0].shape[1] for b in buckets)
    improved = torch.zeros(5, dtype=torch.bool, device=dev)
    with full_f32_products():
        sweep.coordinate_step(w, cur, improved, order_T[0], buckets)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            w1, cur1, _ = sweep.coordinate_step(w, cur, improved,
                                                order_T[0], buckets)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(w1).all()), "sync-free coordinate step: NaN")
    with full_f32_products():
        profiled("coordinate step", lambda: sweep.coordinate_step(
            w, cur, improved, order_T[1], buckets))
    ms_sweep = float(np.median(sweeps))
    print(f"  one coordinate step ran under set_sync_debug_mode('error'): "
          f"no host sync")
    print(f"  wall per sweep (median of {len(sweeps)}) {ms_sweep:.1f} ms, "
          f"{ms_sweep / train.n_features:.2f} ms a coordinate; fit "
          f"{wall:.2f} s; peak device memory {peak / 2**20:.1f} MiB "
          f"(candidate scores of the largest chunk: {rows} padded docs x "
          f"260 candidates x 4 B = {rows * 260 * 4 / 2**20:.1f} MiB)  "
          f"[{smi}]")
    return {"ms_sweep": ms_sweep, "peak": peak, "wall": wall}


def rankboost_phase(dev, train, smi) -> dict:
    """RankBoost at the training width, -round 300 -tc 10, with the
    histogram counter at 0: one launch a round. B1 against its plain
    version on the fit's last π, its own time (bare launches), the
    ``index_add_`` time and the bound; a round under
    ``set_sync_debug_mode("error")``."""
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models import rankboost as PRB
    from ranklib_tpu_torch.ops import histogram as H

    scorer = create_scorer("NDCG@10")
    rb = PRB.RankBoost(n_rounds=RB_ROUNDS, n_threshold=RB_TC)
    rounds = []
    torch.cuda.synchronize()
    H.histogram.launches = 0
    t0 = time.perf_counter()
    with timed_steps(PRB.RankBoost, rounds):
        quiet(rb.fit, train, scorer, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = H.histogram.launches
    tm = rb.fit_state.train_m[:len(rounds)].cpu().numpy()
    print(f"  RankBoost -round {RB_ROUNDS} -tc {RB_TC}: {len(rounds)} "
          f"rounds, {len(rb.weaks)} weak rankers, histogram launches "
          f"{launches}; train NDCG@10 round 1 {tm[0]:.4f} -> round "
          f"{len(rounds)} {tm[-1]:.4f}")
    check(launches == len(rounds), "RankBoost did not launch the histogram "
                                   "kernel once a round")
    check(len(rb.weaks) == RB_ROUNDS and bool(np.isfinite(tm).all())
          and tm[-1] > tm[0], "RankBoost stopped early or did not learn")
    step, state, data, _ = rb.prepare_fit(train, scorer, None, dev)
    step(state, 0, data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = step(state, 1, data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(state.scores).all()), "sync-free round: NaN")
    print("  one round ran under set_sync_debug_mode('error'): no host sync")
    profiled("round", lambda: step(state, 2, data))

    binsT, ones = data.binned_T, data.ones
    F, N = binsT.shape
    B = RB_TC + 1
    pot = PRB.pair_potential(rb.fit_state.scores, data.tb, data.uniq, N)
    got = H.histogram(binsT, pot, ones, B)
    want = H.histogram_plain(binsT, pot, ones, B)
    torch.cuda.synchronize()
    check(torch.equal(got[..., 1], want[..., 1]),
          "histogram counts differ at RankBoost's shape")
    check(torch.allclose(got[..., 0], want[..., 0], **HIST_TOL),
          "histogram sums differ at RankBoost's shape")
    check(torch.equal(got, H.histogram(binsT, pot, ones, B)),
          "histogram not reproducible at RankBoost's shape")
    err = float((got - want).abs().max())
    fn, args, keep = hist_bare(binsT, pot, ones.to(torch.float32), B)
    ms = bare_ms(fn, args)
    check(torch.equal(keep[0], got), "the bare histogram launches wrote "
                                     "another histogram")
    plain_ms = event_ms(lambda: H.histogram_plain(binsT, pot, ones, B), 3)
    idx = (torch.arange(F, device=dev)[:, None] * B
           + binsT.to(torch.int64)).reshape(-1)
    src = torch.stack([pot.expand(F, N).reshape(-1),
                       torch.ones(F * N, device=dev)], dim=-1)
    lib_ms = event_ms(lambda: torch.zeros((F * B, 2), device=dev).index_add_(
        0, idx, src), 10)
    del idx, src
    bnd = bound(nbytes(binsT, pot, ones, got), 2 * F * N)
    ms_round = float(np.median(rounds))
    print(f"  histogram [{F}, {N}] int16, B = {B}, on the fit's last pi: "
          f"max_abs_err {err:.3e} (counts exact); kernel {ms:.4f} ms (20 "
          f"bare launches) vs plain {plain_ms:.4f} ms; index_add_ "
          f"{lib_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
    print(f"  wall per round (median of {len(rounds)}) {ms_round:.3f} ms; "
          f"fit {wall:.2f} s  [{smi}]")
    return {"launches": launches, "shape": [F, N, B], "err": err, "ms": ms,
            "plain_ms": plain_ms, "bound": bnd, "library_ms": lib_ms,
            "ms_round": ms_round, "wall": wall}


def adarank_linear_phase(dev, train, smi) -> dict:
    """AdaRank -round 500 (wall per round) and Linear Regression (fit and
    scoring walls) at the training width."""
    from ranklib_tpu_torch.data.dataset import flatten
    from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
    from ranklib_tpu_torch.models.adarank import AdaRank
    from ranklib_tpu_torch.models.linear import LinearRegRank
    from ranklib_tpu_torch.ops.batched_eval import full_f32_products

    scorer = create_scorer("NDCG@10")
    ada = AdaRank(n_rounds=ADA_ROUNDS)
    rounds = []
    t0 = time.perf_counter()
    with timed_steps(AdaRank, rounds):
        _, out = quiet(ada.fit, train, scorer, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stop = [ln for ln in out.splitlines() if ln.startswith("Stop")]
    tm = ada.fit_state.train_m[:len(rounds)].cpu().numpy()
    print(f"  AdaRank -round {ADA_ROUNDS}: {len(rounds)} rounds run, "
          f"{len(ada.history)} kept ({stop[0] if stop else 'no stop'}); "
          f"features {[f for f, _ in ada.history][:10]}...; train NDCG@10 "
          f"{np.nanmax(tm):.4f}")
    check(ada.history and bool(np.isfinite(ada.weights).all()),
          "AdaRank kept no round")
    m, _ = score_dataset(scorer, train, ada.eval_dataset(train, dev), dev)
    check(abs(m - float(tm[len(ada.history) - 1])) <= 1e-3,
          "AdaRank's rescored model disagrees with its last kept round")
    ms_round = float(np.median(rounds))
    print(f"  wall per round (median of {len(rounds)}) {ms_round:.3f} ms; "
          f"fit {wall:.2f} s  [{smi}]")
    step, state, S, tb, vb = ada.prepare_fit(train, scorer, None, dev)
    with full_f32_products():
        profiled("round", lambda: step(state, 0, S, tb, vb))

    lr = LinearRegRank()
    t0 = time.perf_counter()
    lr.fit(train)
    fit_s = time.perf_counter() - t0
    score_ms = wall_ms(lambda: lr.eval_dataset(train, dev), 5)
    feats, labels, _ = flatten(train)
    want = feats.astype(np.float64) @ lr.weights[1:] + lr.weights[0]
    got = np.concatenate(lr.eval_dataset(train, dev))
    err = float(np.abs(got - want).max())
    m, _ = score_dataset(scorer, train, lr.eval_dataset(train, dev), dev)
    print(f"  Linear Regression: fit (f64 host normal equations) "
          f"{fit_s:.3f} s; scoring {train.n_docs} docs on the card "
          f"{score_ms:.3f} ms wall; f32 scores vs f64 max_abs_err "
          f"{err:.3e}; train NDCG@10 {m:.4f}  [{smi}]")
    check(err <= 1e-4 * max(1.0, float(np.abs(want).max())),
          "Linear Regression's device scores disagree with the f64 model")
    return {"ada_ms_round": ms_round, "ada_wall": wall, "lr_fit_s": fit_s,
            "lr_score_ms": score_ms}


def linear_boosting_card_vs_cpu(dev) -> None:
    """200 queries: RankBoost's first 20 weak rankers (the histogram
    kernel on the card, its plain version on the CPU), Coordinate Ascent
    one restart one pass, AdaRank's first 20 picks."""
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models.adarank import AdaRank
    from ranklib_tpu_torch.models.coorascent import CoorAscent
    from ranklib_tpu_torch.models.rankboost import RankBoost

    ds = synth_queries(200, N_FEATURES, seed=5, w_seed=11)
    scorer = create_scorer("NDCG@10")
    cpu = torch.device("cpu")
    fits = []
    for d in (cpu, dev):
        t0 = time.perf_counter()
        rb = RankBoost(n_rounds=20)
        quiet(rb.fit, ds, scorer, device=d)
        ca = CoorAscent(n_restart=1, max_passes=1)
        quiet(ca.fit, ds, scorer, device=d)
        ada = AdaRank(n_rounds=20)
        quiet(ada.fit, ds, scorer, device=d)
        fits.append((rb.weaks, ca.weights, ada.history))
        print(f"  {d.type}: RankBoost, Coordinate Ascent and AdaRank "
              f"{time.perf_counter() - t0:.1f} s")
    (rb_c, ca_c, ada_c), (rb_d, ca_d, ada_d) = fits
    same = [a[:2] == b[:2] for a, b in zip(rb_c, rb_d)]
    first = same.index(False) + 1 if False in same else None
    alpha = max(abs(a[2] - b[2]) / abs(a[2]) for a, b in zip(rb_c, rb_d))
    print(f"  RankBoost: {sum(same)} of {len(same)} weak rankers identical "
          f"(first to differ: {first}); alphas differ by at most "
          f"{alpha:.2e} relative")
    check(len(rb_c) == len(rb_d) == 20 and all(same),
          "RankBoost's first 20 weak rankers differ between card and CPU")
    check(alpha <= 1e-4, "RankBoost's alphas differ between card and CPU")
    err = float(np.abs(ca_c - ca_d).max())
    print(f"  Coordinate Ascent (1 restart, 1 pass): weights differ by at "
          f"most {err:.2e}")
    check(err <= 1e-5, "Coordinate Ascent's weights differ card vs CPU")
    picks = [[f for f, _ in h] for h in (ada_c, ada_d)]
    print(f"  AdaRank: picks {picks[0]} (CPU) vs {picks[1]} (card)")
    check(picks[0] == picks[1], "AdaRank's picks differ card vs CPU")


def linear_boosting_cli(tmp) -> None:
    """-train with no -ranker (Coordinate Ascent), then -ranker 2 (-round
    100), 3 and 9, each with -norm zscore -validate -test -save, then
    -load -test of each saved model: the same test metric."""
    from ranklib_tpu_torch import cli

    paths = {n: os.path.join(tmp, f"{n}.txt")
             for n in ("train", "vali", "test")}
    for ranker in (None, 2, 3, 9):
        model = os.path.join(tmp, f"linear{ranker}.txt")
        flags = [] if ranker is None else ["-ranker", str(ranker)]
        if ranker == 2:
            flags += ["-round", "100"]        # of 300: the smoke's time
        t0 = time.perf_counter()
        rc, out = quiet(cli.main, [
            "-train", paths["train"], *flags, "-norm", "zscore",
            "-metric2t", "NDCG@10", "-validate", paths["vali"],
            "-test", paths["test"], "-save", model])
        check(rc == 0, f"-train {' '.join(flags) or '(default)'} failed:\n"
                       f"{out[-2000:]}")
        wall = time.perf_counter() - t0
        trained = [ln for ln in out.splitlines()
                   if " on " in ln and "data:" in ln]
        rc, out = quiet(cli.main, ["-load", model, "-test", paths["test"],
                                   "-norm", "zscore", "-metric2T",
                                   "NDCG@10"])
        check(rc == 0, f"-load of the {model} model failed")
        loaded = [ln for ln in out.splitlines() if " on test data" in ln]
        with open(model) as f:
            name = f.readline().strip()
        print(f"  -train {' '.join(flags) or '(no -ranker)'} -norm zscore "
              f"({name}, {wall:.1f} s): {'; '.join(trained[-3:])}; -load: "
              f"{loaded[0]}")
        check(name == "## Coordinate Ascent" if ranker is None else True,
              "-train without -ranker did not train Coordinate Ascent")
        check(loaded[0] == trained[-1],
              "the loaded model's test metric differs from training's")


def neural_phase(dev, train, vali, smi) -> dict:
    """RankLib's default nets on phase 5's data (1,500 queries x 136
    features, 300 validation queries): RankNet and LambdaRank 1 x 10 at lr
    5e-5, ListNet linear at lr 1e-5, NDCG@10. Epochs cut from 100, 100
    and 1,500 to 2, 2 and 3 for the time limit. TF32 is enabled outside
    the fits, and every query step and forward pass must run in full f32.
    Per ranker: median wall ms an epoch, µs a query step (every 5th step
    alone, synchronised), CUDA kernels a query step and the device's busy share
    of an epoch (``torch.profiler``), peak memory, one query step under
    ``set_sync_debug_mode("error")``, and the kept parameters rescored on
    the validation queries against the fit's best epoch."""
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models import neural as PN

    scorer = create_scorer("NDCG@10")
    modes = []
    watched = {}
    for name in ("query_step", "_forward"):
        orig = getattr(PN, name)

        def watch(*a, _orig=orig, **kw):
            modes.append((torch.backends.cuda.matmul.allow_tf32,
                          torch.get_float32_matmul_precision()))
            return _orig(*a, **kw)

        watched[name] = orig
        setattr(PN, name, watch)
    out = {}
    try:
        for cls, epochs in ((PN.RankNet, NN_EPOCHS[0]),
                            (PN.LambdaRank, NN_EPOCHS[1]),
                            (PN.ListNet, NN_EPOCHS[2])):
            out[cls.NAME] = neural_fit(dev, cls, epochs, train, vali, scorer,
                                       modes, smi)
    finally:
        for name, orig in watched.items():
            setattr(PN, name, orig)
        torch.set_float32_matmul_precision("highest")
    check(modes and all(m == (False, "highest") for m in modes),
          "a neural ranker's product ran with TF32 enabled")
    print(f"  {len(modes)} query steps and forward passes, each in full f32 "
          f"(TF32 enabled outside the fits)")
    return out


def neural_fit(dev, cls, epochs, train, vali, scorer, modes, smi) -> dict:
    """One ranker of :func:`neural_phase`."""
    from ranklib_tpu_torch.metrics.base import score_dataset
    from ranklib_tpu_torch.ops.batched_eval import full_f32_products

    r = cls(n_epoch=epochs)
    times = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.set_float32_matmul_precision("high")        # TF32 outside the fit
    t0 = time.perf_counter()
    with timed_steps(cls, times):
        _, text = quiet(r.fit, train, scorer, vali, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    table = [ln.strip() for ln in text.splitlines()
             if ln[:1].isdigit() and "|" in ln]
    m, _ = score_dataset(scorer, vali, r.eval_dataset(vali, dev), dev)
    vals = [float(ln.split("|")[2]) for ln in table]
    check(all(np.isfinite(W).all() and np.isfinite(b).all()
              for W, b in r.params), f"{cls.NAME}: parameters not finite")
    check(len(times) == epochs and all(np.isfinite(vals)),
          f"{cls.NAME}: the fit did not run its epochs")
    check(abs(m - max(vals)) <= 1e-4, f"{cls.NAME}: the kept parameters "
                                      f"do not score the best epoch's "
                                      f"validation metric")
    step, state, data, vb = r.prepare_fit(train, scorer, vali, dev)
    rows = data.rows
    with full_f32_products():
        step.query_step(state.params, rows[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step.query_step(state.params, rows[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sample = rows[::5]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for row in sample:
            step.query_step(state.params, row)
        torch.cuda.synchronize()
        us_step = (time.perf_counter() - t1) * 1e6 / len(sample)
    k_epoch, busy, ep_wall = kernel_profile(
        lambda: step(state, 0, data, vb))
    check(all(bool(torch.isfinite(W).all()) for W, _ in state.params),
          f"{cls.NAME}: a query step gave NaN")
    ms_epoch = float(np.median(times))
    k_step = k_epoch / len(rows)
    print(f"  {cls.NAME} {r._layer_sizes(train.n_features)}, lr "
          f"{r.learning_rate:g}, {epochs} epochs (of RankLib's "
          f"{cls().n_epoch}): {'; '.join(table)}; kept parameters score "
          f"validation NDCG@10 {m:.4f}")
    print(f"    wall per epoch (median of {len(times)}) {ms_epoch:.1f} ms; "
          f"{us_step:.1f} us a query step (every 5th of {len(rows)} "
          f"alone, synchronised); a profiled epoch: {k_epoch} CUDA kernels, "
          f"{k_step:.1f} a query step (the epoch's validation and pair "
          f"count included), device busy {busy:.3f} ms of {ep_wall:.1f} ms "
          f"({100 * busy / ep_wall:.1f}%); fit {wall:.2f} s; peak device "
          f"memory {peak / 2**20:.1f} MiB; one query step ran under "
          f"set_sync_debug_mode('error')  [{smi}]")
    return {"ms_epoch": ms_epoch, "us_step": us_step,
            "kernels_step": k_step, "busy": busy / ep_wall,
            "peak": peak}


def kernel_profile(fn) -> tuple:
    """(CUDA kernels, device-busy ms, wall ms) of one call of fn under
    ``torch.profiler``, tracing the device only. It reads the profiler's
    raw events, not ``key_averages``, which builds a Python object per
    event of an epoch's ~164K kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    check(len(ns) > 0, "the profiler saw no kernels")
    return len(ns), sum(ns) / 1e6, wall


def neural_card_vs_cpu(dev) -> None:
    """200 queries, 1 epoch of each neural ranker on the CPU and on the
    card from the same seeded initial draws (the CPU generator's), at 10x
    RankLib's learning rates so that the parameters move well past the
    tolerance: parameters within 1e-5."""
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models import neural as PN

    ds = synth_queries(200, N_FEATURES, seed=5, w_seed=11)
    scorer = create_scorer("NDCG@10")
    for cls in (PN.RankNet, PN.LambdaRank, PN.ListNet):
        init = PN._init_params(torch.Generator().manual_seed(0),
                               cls()._layer_sizes(N_FEATURES))
        fits = []
        for d in (torch.device("cpu"), dev):
            r = cls(n_epoch=1)
            r.learning_rate *= 10
            t0 = time.perf_counter()
            quiet(r.fit, ds, scorer, device=d)
            fits.append(r.params)
            print(f"  {cls.NAME} {d.type}: {time.perf_counter() - t0:.1f} s")
        err = max(float(np.abs(a - b).max())
                  for pa, pb in zip(*fits) for a, b in zip(pa, pb))
        moved = max(float(np.abs(a - b.numpy()).max())
                    for pa, pb in zip(fits[0], init) for a, b in zip(pa, pb))
        print(f"  {cls.NAME}: card vs CPU parameters differ by at most "
              f"{err:.2e} (the CPU's moved up to {moved:.2e} from the start)")
        check(err <= 1e-5, f"{cls.NAME}: parameters differ card vs CPU")


def neural_cli(tmp) -> None:
    """-kcv 3 with -ranker 6 (the histogram, split-scan and frombins
    counters at 0 must rise; each fold model loads with -load -test) and
    with -ranker 1 -epoch 1; -ranker 5 and 7 -epoch 1 with -validate -test
    -save, then -load -test; -load -test -qrel of a qrel file with
    permuted labels, on the card and on the CPU: the same line."""
    from ranklib_tpu_torch import cli
    from ranklib_tpu_torch.ops import forest_eval as fe
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import split_scan as SS

    paths = {n: os.path.join(tmp, f"{n}.txt")
             for n in ("train", "vali", "test")}
    kdir = os.path.join(tmp, "kcv")
    H.histogram.launches = 0
    SS.best_splits.launches = 0
    fe.forest_eval_frombins.launches = 0
    t0 = time.perf_counter()
    rc, out = quiet(cli.main, ["-train", paths["train"], "-ranker", "6",
                               "-tree", "20", "-leaf", str(N_LEAVES),
                               "-metric2t", "NDCG@10", "-kcv", "3",
                               "-kcvmd", kdir, "-kcvmn", "lm"])
    torch.cuda.synchronize()
    launches = {"histogram": H.histogram.launches,
                "split_scan": SS.best_splits.launches,
                "forest_eval_frombins": fe.forest_eval_frombins.launches}
    check(rc == 0, f"-kcv 3 -ranker 6 failed:\n{out[-2000:]}")
    summary = out.splitlines()[out.splitlines().index("Summary:"):]
    print(f"  -train -ranker 6 -tree 20 -kcv 3 ({time.perf_counter() - t0:.1f}"
          f" s): launches {launches}; {' / '.join(summary[-4:])}")
    check(all(v > 0 for v in launches.values()),
          "-kcv -ranker 6 did not launch the histogram, split-scan and "
          "frombins kernels")
    for k in (1, 2, 3):
        rc, out = quiet(cli.main, ["-load", os.path.join(kdir, f"f{k}.lm"),
                                   "-test", paths["test"]])
        check(rc == 0 and "on test data" in out,
              f"-load of the fold model f{k}.lm failed")
    rc, out = quiet(cli.main, ["-train", paths["train"], "-ranker", "1",
                               "-epoch", "1", "-kcv", "3"])
    check(rc == 0 and "Summary:" in out, "-kcv 3 -ranker 1 failed")
    print(f"  -train -ranker 1 -epoch 1 -kcv 3: "
          f"{out.splitlines()[-1].strip()}")
    for ranker in ("5", "7"):
        model = os.path.join(tmp, f"neural{ranker}.txt")
        rc, out = quiet(cli.main, [
            "-train", paths["train"], "-ranker", ranker, "-epoch", "1",
            "-metric2t", "NDCG@10", "-validate", paths["vali"], "-test",
            paths["test"], "-save", model])
        check(rc == 0, f"-train -ranker {ranker} failed:\n{out[-2000:]}")
        trained = [ln for ln in out.splitlines()
                   if " on " in ln and "data:" in ln]
        rc, out = quiet(cli.main, ["-load", model, "-test", paths["test"],
                                   "-metric2T", "NDCG@10"])
        loaded = [ln for ln in out.splitlines() if " on test data" in ln]
        print(f"  -train -ranker {ranker} -epoch 1: {'; '.join(trained)}; "
              f"-load: {loaded[0] if loaded else '-'}")
        check(rc == 0 and loaded[0] == trained[-1],
              "the loaded model's test metric differs from training's")
    qrel = os.path.join(tmp, "test.qrel")
    rng = np.random.default_rng(9)
    with open(paths["test"]) as f, open(qrel, "w") as g:
        for line in f:
            qid, doc = line.split()[1][4:], line.split("#")[1].strip()
            g.write(f"{qid} 0 {doc} {int(rng.integers(0, 5))}\n")
    lines = {}
    for model in (os.path.join(tmp, "neural5.txt"),
                  os.path.join(kdir, "f1.lm")):
        for where in ("cuda", "cpu"):
            os.environ["RANKLIB_TPU_TORCH_DEVICE"] = where
            try:
                rc, out = quiet(cli.main, ["-load", model, "-test",
                                           paths["test"], "-qrel", qrel,
                                           "-metric2T", "NDCG@10"])
            finally:
                del os.environ["RANKLIB_TPU_TORCH_DEVICE"]
            check(rc == 0 and "Relevance judgments loaded" in out,
                  f"-qrel on {where} failed")
            lines[where] = [ln for ln in out.splitlines()
                            if " on test data" in ln]
        print(f"  -load {os.path.basename(model)} -test -qrel (permuted "
              f"labels): card {lines['cuda']}, CPU {lines['cpu']}")
        check(lines["cuda"] == lines["cpu"],
              "-qrel prints another line on the card than on the CPU")


def write_sparse_letor(path, ds) -> None:
    """LETOR lines that list only the features present in a document (the
    non-zero ones), as the Yahoo! files do."""
    from ranklib_tpu_torch.data.dataset import flatten

    X, labels, qptr = flatten(ds)
    with open(path, "w") as f:
        for q in range(len(qptr) - 1):
            for i in range(qptr[q], qptr[q + 1]):
                feats = " ".join(f"{j + 1}:{X[i, j]:.6g}"
                                 for j in np.flatnonzero(X[i]))
                f.write(f"{int(labels[i])} qid:{q + 1} {feats} "
                        f"# doc{q + 1}_{i - qptr[q]}\n")


# one load in a process of its own, for its wall and peak RSS (VmRSS read
# every millisecond by a thread: a forked child's ru_maxrss starts from its
# parent's, and not every kernel reports VmHWM): the streamed loader
# (-sparse) or the dense pipeline's host work before the upload (parse,
# flatten, grid, int32 bins)
_LOAD_CODE = """
import json, sys, threading, time
sys.path.insert(0, sys.argv[1])
from ranklib_tpu_torch.data.binned import read_letor_binned
from ranklib_tpu_torch.data.dataset import flatten
from ranklib_tpu_torch.data.letor import read_letor
from ranklib_tpu_torch.gbdt.binning import bin_features, compute_thresholds
from ranklib_tpu_torch.utils.logging import set_silent
set_silent(True)
def rss():
    with open('/proc/self/status') as f:
        return next(int(ln.split()[1]) * 1024 for ln in f
                    if ln.startswith('VmRSS:'))
before = rss()
peak = [before]
done = threading.Event()
def sample():
    while not done.is_set():
        peak[0] = max(peak[0], rss())
        time.sleep(0.001)
sampler = threading.Thread(target=sample)
sampler.start()
t0 = time.perf_counter()
if sys.argv[3] == 'sparse':
    shape = read_letor_binned(sys.argv[2]).binned.shape
else:
    feats = flatten(read_letor(sys.argv[2], missing_zero=True))[0]
    shape = bin_features(feats, compute_thresholds(feats, 256)[0]).shape
wall = time.perf_counter() - t0
done.set()
sampler.join()
peak = max(peak[0], rss())
print(json.dumps({'s': wall, 'before': before, 'peak': peak,
                  'shape': list(shape)}))
"""


def _cloned(x):
    """``x`` with every tensor in it cloned (tuples, lists and dicts
    walked; anything else kept as it is)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_cloned(v) for v in x)
    if isinstance(x, dict):
        return {k: _cloned(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def kept_calls(module, name: str, calls: list):
    """Inside the block ``module.<name>``, a kernel wrapper that the module
    calls by that name, becomes one that calls it and appends clones of
    its arguments and of its result to ``calls``, so that every launch of
    a run can be held against the plain version afterwards on the very
    tensors the run gave it. The wrapper's own launch count is untouched."""
    orig = getattr(module, name)

    def kept(*args, **kw):
        out = orig(*args, **kw)
        calls.append((_cloned(args), _cloned(kw), _cloned(out)))
        return out

    setattr(module, name, kept)
    try:
        yield
    finally:
        setattr(module, name, orig)


def hold_scans(calls: list, what: str) -> float:
    """Each kept split-scan launch against the plain version on its own
    histograms. The fits' gradient sums are float sums with cancellation
    (a query's lambdas sum to zero), so two f32 orders differ by more than
    a fixed rtol; the gains are held instead against the f64 scan, within
    the f32 error bound of each candidate: a prefix of B terms errs by at
    most B·u·Σ|g| (u = 2^-24, Σ|g| the row's absolute gradient sum; the
    right side's, total minus prefix, by twice that), which moves s²/c by
    at most (2|s|δ + δ²)/c; the bound is the largest over the node's valid
    candidates, plus 4u of the gain. Checked per node: ok flags equal to
    the plain version's; the kernel's gain within the bound of the f64
    gain at its own pick; that pick a best split up to twice the bound;
    and on the histograms rounded to integers every output exact. The
    counts (Σ of integer document weights) must be integers, as the bound
    assumes. Returns the largest |kernel gain − f64 gain at its pick|."""
    from ranklib_tpu_torch.ops import split_scan as SS

    u = 2.0 ** -24
    err = 0.0
    for args, kw, got in calls:
        hist, mls = args[0], args[1]
        fmask = args[2] if len(args) > 2 else kw.get("fmask")
        want = SS.best_splits_plain(hist, mls, fmask)
        check(torch.equal(got[3], want[3]),
              f"split scan on {what}: ok flags differ from the plain version")
        h = (hist if isinstance(hist, torch.Tensor)
             else torch.cat(list(hist))).double()
        check(torch.equal(h[..., 1], h[..., 1].round()),
              f"split scan on {what}: counts are not integers")
        B = h.shape[2]
        c_l = torch.cumsum(h[..., 1], dim=2)
        s_l = torch.cumsum(h[..., 0], dim=2)
        c_r = c_l[..., -1:] - c_l
        s_r = s_l[..., -1:] - s_l
        gain = s_l * s_l / c_l.clamp(min=1.0) + s_r * s_r / c_r.clamp(min=1.0)
        d = B * u * h[..., 0].abs().sum(dim=2, keepdim=True)
        slack = ((2 * s_l.abs() * d + d * d) / c_l.clamp(min=1.0)
                  + (4 * s_r.abs() * d + 4 * d * d) / c_r.clamp(min=1.0))
        valid = (c_l >= max(float(mls), 1e-9)) & (c_r >= max(float(mls), 1e-9))
        if fmask is not None:
            valid = valid & fmask[:, :, None]
        gain = torch.where(valid, gain, -torch.inf)
        Cn = h.shape[0]
        best = gain.reshape(Cn, -1).max(dim=1).values
        tol = (torch.where(valid, slack, 0.0).reshape(Cn, -1).max(dim=1)
               .values + 4 * u * best.abs())
        node = torch.arange(Cn, device=h.device)
        at_pick = gain[node, got[1].long(), got[2].long()]
        ok = got[3]
        gap = (got[0].double() - at_pick).abs()[ok]
        check(bool((gap <= tol[ok]).all()), f"split scan on {what}: a gain "
              f"is off the f64 gain at its pick by more than the f32 bound")
        check(bool((at_pick[ok] >= best[ok] - 2 * tol[ok]).all()),
              f"split scan on {what}: a pick is not a best split within "
              f"the f32 bound")
        if ok.any():
            err = max(err, float(gap.max()))
        ints = (hist.round() if isinstance(hist, torch.Tensor)
                else tuple(p.round() for p in hist))
        for a, b in zip(SS.best_splits(ints, mls, fmask),
                        SS.best_splits_plain(ints, mls, fmask)):
            check(torch.equal(a, b), f"split scan on {what}: not exact on "
                                     f"the integer-rounded histograms")
    return err


def hold_frombins(calls: list, what: str) -> None:
    """Each kept frombins launch bit-equal to the plain version on its own
    ids and pack."""
    from ranklib_tpu_torch.ops import forest_eval as fe

    for (binsT, pack), _, got in calls:
        want = fe.forest_eval_frombins_plain(
            binsT, *pack.matmul_operands(), tree_chunk=pack.tree_chunk)
        check(torch.equal(got, want), f"frombins on {what}: not bit-equal "
                                      f"to the plain version")


def hist_point(binsT, w, B: int = 256) -> tuple:
    """The histogram kernel on ``binsT`` under weights ``w`` against its
    plain version and the ``index_add_`` over the flat f*B + bin index:
    (error, device times and the bound; the kernel's histogram). The
    gradients are integers in
    [-8, 8], so every sum is exact in f32 in any order and kernel and
    plain version must agree exactly: at 90% zeros one bin of a feature
    holds most documents, and N(0,1) sums that long differ in their last
    bits with the order (HIST_TOL is set for bins of ~700 documents)."""
    from ranklib_tpu_torch.ops import histogram as H

    F, N = binsT.shape
    dev = binsT.device
    grad = torch.from_numpy(np.random.default_rng(9).integers(
        -8, 9, size=N).astype(np.float32)).to(dev)
    got = H.histogram(binsT, grad, w, B)
    want = H.histogram_plain(binsT, grad, w, B)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"histogram differs from its plain version at [{F}, {N}]")
    wf = w.to(torch.float32)
    idx = (torch.arange(F, device=dev)[:, None] * B
           + binsT.to(torch.int64)).reshape(-1)
    # N(0,1) gradients: each f32 sum against the f64 one
    g = torch.from_numpy(np.random.default_rng(10).normal(
        size=N).astype(np.float32)).to(dev)
    exact = torch.zeros(F * B, dtype=torch.float64, device=dev).index_add_(
        0, idx, (g.double() * wf.double()).expand(F, N).reshape(-1))
    errs = [float((h(binsT, g, w, B)[..., 0].reshape(-1).double()
                   - exact).abs().max())
            for h in (H.histogram, H.histogram_plain)]
    print(f"  histogram [{F}, {N}], N(0,1) gradients, sums against f64: "
          f"kernel max_abs_err {errs[0]:.3e}, plain (index_add_ in f32) "
          f"{errs[1]:.3e}")
    del exact
    src = torch.stack([(grad * wf).expand(F, N).reshape(-1),
                       wf.expand(F, N).reshape(-1)], dim=-1)
    out = {"max_abs_err": float((got - want).abs().max()),
           "ms": event_ms(lambda: H.histogram(binsT, grad, w, B), 20),
           "plain_ms": event_ms(lambda: H.histogram_plain(binsT, grad, w, B),
                                3),
           "library_ms": event_ms(lambda: torch.zeros(
               (F * B, 2), device=dev).index_add_(0, idx, src), 10)}
    out["bound_ms"], out["bound_by"] = bound(nbytes(binsT, grad, w, got),
                                             2 * F * int(w.sum()))
    return out, got


def sparse_phase(dev, tmp, smi) -> dict:
    """-sparse at 700 features: the streamed load's wall and host peak RSS
    beside the dense pipeline's; LambdaMART (validation) and Random Forests
    trained through the CLI with and without -sparse (byte-equal models,
    the streamed BinnedDataset reaching the fit, B1/B7, B2 and B4
    launched); -load -test with and without -sparse (the same lines);
    every split-scan and frombins launch of those runs held against its
    plain version on the run's own tensors; -ana, and the randomization
    test timed on the card (with injected signs its p-value equals the
    CPU's); the histogram at the streamed bin matrix's shape, and the
    split scan on its root histogram under integer gradients, exact."""
    from ranklib_tpu_torch import cli, evaluator
    from ranklib_tpu_torch.data.binned import read_letor_binned
    from ranklib_tpu_torch.gbdt import ensemble as ens_mod
    from ranklib_tpu_torch.gbdt import grow as grow_mod
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.ops import forest_eval as fe
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import split_scan as SS
    from ranklib_tpu_torch.stats.significance import randomization_test

    counters = {"histogram": H.histogram,
                "histogram_multi": H.histogram_multi,
                "split_scan": SS.best_splits,
                "forest_eval_frombins": fe.forest_eval_frombins}
    paths = {}
    t0 = time.perf_counter()
    for name, nq, seed in (("train", SP_QUERIES, 21),
                           ("vali", SP_VQUERIES, 22)):
        paths[name] = os.path.join(tmp, f"sparse_{name}.txt")
        write_sparse_letor(paths[name], synth_queries(
            nq, SP_FEATURES, seed, 23, density=SP_DENSITY))
    print(f"  wrote {SP_QUERIES} + {SP_VQUERIES} queries x {SP_FEATURES} "
          f"features, {SP_DENSITY:.0%} present "
          f"({os.path.getsize(paths['train']) / 2**20:.1f} MiB) in "
          f"{time.perf_counter() - t0:.1f} s")
    root = os.path.dirname(os.path.abspath(__file__))
    loads = {}
    for mode in ("dense", "sparse"):
        proc = subprocess.run([sys.executable, "-c", _LOAD_CODE, root,
                               paths["train"], mode], capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0, f"the {mode} load failed:\n"
                                    f"{proc.stderr[-2000:]}")
        loads[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
        v = loads[mode]
        print(f"  {mode} load of the training file ({v['shape'][0]} docs x "
              f"{v['shape'][1]}): {v['s']:.3f} s wall, host peak RSS "
              f"{v['peak'] / 2**20:.1f} MiB ({(v['peak'] - v['before']) / 2**20:.1f}"
              f" MiB above the process before the load)")
    check(loads["dense"]["shape"] == loads["sparse"]["shape"],
          "the streamed bin matrix has another shape than the dense one")

    seen = []
    orig = evaluator.train_ranker

    def recording(ranker_type, train, *a, **k):
        seen.append(type(train).__name__)
        return orig(ranker_type, train, *a, **k)

    evaluator.train_ranker = recording
    runs = {}
    scan_calls, fb_calls = [], []
    held = {"split_scan": 0, "forest_eval_frombins": 0}
    scan_err = 0.0
    def train(ranker, extra, model, mode):
        return quiet(cli.main, [
            "-train", paths["train"], "-ranker", ranker, *extra,
            "-metric2t", "NDCG@10", "-tc", "256", "-missingZero",
            "-save", model, *(["-sparse"] if mode == "sparse" else [])])

    try:
        for ranker, extra in (
                ("6", ["-tree", str(SP_TREES), "-leaf", str(N_LEAVES),
                       "-validate", paths["vali"]]),
                ("8", ["-bag", str(SP_BAGS)])):
            for mode in ("dense", "sparse"):
                model = os.path.join(tmp, f"sparse_model{ranker}_{mode}.txt")
                seen.clear()
                times = []
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                with timed_rounds(times):
                    rc, out = train(ranker, extra, model, mode)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {k: c.launches for k, c in counters.items()}
                check(rc == 0, f"-train -ranker {ranker} ({mode}) failed:"
                               f"\n{out[-2000:]}")
                lines = [ln for ln in out.splitlines()
                         if " on " in ln and "data:" in ln]
                runs[ranker, mode] = {"model": model, "lines": lines,
                                      "launches": launches, "wall": wall,
                                      "ms_round": (float(np.median(times))
                                                   if times else None),
                                      "dataset": list(seen)}
                print(f"  -train -ranker {ranker} {mode}: {wall:.1f} s, "
                      f"{len(times)} rounds"
                      + (f" at {np.median(times):.3f} ms a round (median)"
                         if times else "")
                      + f"; launches {launches}; {'; '.join(lines)}")
                if mode == "sparse":
                    check("not applicable" not in out and seen ==
                          ["BinnedDataset"], f"-sparse -ranker {ranker} "
                          f"fell back to the dense pipeline ({seen})")
            dense, sparse = runs[ranker, "dense"], runs[ranker, "sparse"]
            with open(dense["model"]) as f, open(sparse["model"]) as g:
                check(f.read() == g.read(), f"-ranker {ranker}: the -sparse "
                      f"model differs from the dense one")
            check(dense["lines"] == sparse["lines"],
                  f"-ranker {ranker}: -sparse printed other metrics")
            grow = "histogram" if ranker == "6" else "histogram_multi"
            for k in (grow, "split_scan", "forest_eval_frombins"):
                check(sparse["launches"][k] > 0, f"-sparse -ranker {ranker} "
                      f"did not launch {k}")
            if ranker == "6":
                want = SP_TREES * (N_LEAVES - 1)
                check(sparse["launches"]["histogram"] == want
                      == sparse["launches"]["split_scan"],
                      f"-sparse LambdaMART: histogram/split-scan launches "
                      f"are not {SP_TREES} x {N_LEAVES - 1}")
            print(f"  -ranker {ranker}: the -sparse model is byte-equal to "
                  f"the dense one; the fit took a BinnedDataset")
            # one more -sparse fit, untimed: every split-scan and frombins
            # call of it held against the plain versions (kept out of the
            # timed runs, where the clones would add launches to a
            # launch-bound round)
            model = os.path.join(tmp, f"sparse_model{ranker}_held.txt")
            with kept_calls(grow_mod, "best_splits", scan_calls), \
                    kept_calls(ens_mod, "forest_eval_frombins", fb_calls):
                rc, out = train(ranker, extra, model, "sparse")
            check(rc == 0, f"-train -ranker {ranker} -sparse failed:\n"
                           f"{out[-2000:]}")
            with open(model) as f, open(sparse["model"]) as g:
                check(f.read() == g.read(), f"-ranker {ranker}: a second "
                      f"-sparse fit wrote another model")
            what = f"the -sparse -ranker {ranker} fit"
            scan_err = max(scan_err, hold_scans(scan_calls, what))
            hold_frombins(fb_calls, what)
            check(len(scan_calls) >= sparse["launches"]["split_scan"] and
                  len(fb_calls) >= sparse["launches"]["forest_eval_frombins"],
                  f"{what}: a launch went past the kept calls")
            held["split_scan"] += len(scan_calls)
            held["forest_eval_frombins"] += len(fb_calls)
            scan_calls.clear()
            fb_calls.clear()
    finally:
        evaluator.train_ranker = orig

    idv_dir = os.path.join(tmp, "sparse_idv")
    os.makedirs(idv_dir, exist_ok=True)
    scored = {}
    for ranker in ("6", "8"):
        for mode in ("dense", "sparse"):
            for c in counters.values():
                c.launches = 0
            idv = os.path.join(tmp if ranker == "6" else idv_dir,
                               f"idv{ranker}_{mode}.txt")
            t0 = time.perf_counter()
            with kept_calls(ens_mod, "forest_eval_frombins", fb_calls):
                rc, out = quiet(cli.main, [
                    "-load", runs[ranker, "sparse"]["model"], "-test",
                    paths["train"], "-metric2T", "NDCG@10", "-missingZero",
                    "-idv", idv, *(["-sparse"] if mode == "sparse" else [])])
            torch.cuda.synchronize()
            check(rc == 0, f"-load -test ({mode}) failed:\n{out[-2000:]}")
            hold_frombins(fb_calls, f"-load -test ({mode}, -ranker {ranker} "
                                    f"model)")
            held["forest_eval_frombins"] += len(fb_calls)
            check(len(fb_calls) >= fe.forest_eval_frombins.launches,
                  "-load -test: a frombins launch went past the kept calls")
            fb_calls.clear()
            scored[ranker, mode] = (
                [ln for ln in out.splitlines() if " on test data" in ln],
                fe.forest_eval_frombins.launches, idv)
            print(f"  -load (-ranker {ranker} model) -test {mode}: "
                  f"{time.perf_counter() - t0:.2f} s, frombins launches "
                  f"{scored[ranker, mode][1]}; {scored[ranker, mode][0]}")
        check(scored[ranker, "dense"][0] == scored[ranker, "sparse"][0],
              "-load -test -sparse printed another line than without")
        check(scored[ranker, "sparse"][1] > 0,
              "-load -test -sparse did not launch the frombins kernel")
    os.remove(scored["8", "dense"][2])          # one run file for -ana
    base_idv = scored["6", "sparse"][2]
    rc, out = quiet(cli.main, ["-ana", "-all", idv_dir, "-base", base_idv,
                               "-np", str(SP_PERMS)])
    check(rc == 0 and "Detailed break down" in out, "-ana failed")
    print("  -ana: " + " | ".join(out.splitlines()[4:6]))

    def per_query(path):
        with open(path) as f:
            return np.array([float(ln.split()[2]) for ln in f
                             if ln.split()[1] != "all"])

    b = per_query(base_idv)
    t = per_query(scored["8", "sparse"][2])
    check(len(b) == SP_QUERIES, "the idv file has the wrong length")
    ana_ms = wall_ms(lambda: randomization_test(b, t, SP_PERMS, seed=1,
                                                device=dev), 5)
    signs = np.where(np.random.default_rng(31).random(
        (SP_PERMS, len(b))) < 0.5, -1.0, 1.0).astype(np.float32)

    def injected(device):
        pos = [0]

        def draw(p, q):
            pos[0] += p
            return torch.from_numpy(signs[pos[0] - p:pos[0]]).to(device)
        return draw

    p_card = randomization_test(b, t, SP_PERMS, device=dev,
                                draw=injected(dev))
    p_cpu = randomization_test(b, t, SP_PERMS, device=torch.device("cpu"),
                               draw=injected(torch.device("cpu")))
    print(f"  randomization test, {SP_PERMS} permutations x {len(b)} "
          f"queries on the card: {ana_ms:.3f} ms (wall, median); injected "
          f"signs: p = {p_card:.4f} on the card, {p_cpu:.4f} on the CPU")
    check(p_card == p_cpu, "the randomization test counts differently on "
                           "the card and on the CPU")
    # a pair whose p-value lies mid-range, where a miscount would show
    near = np.round(b + np.random.default_rng(32).normal(0.002, 0.05,
                                                         len(b)), 4)
    p_card = randomization_test(b, near, SP_PERMS, device=dev,
                                draw=injected(dev))
    p_cpu = randomization_test(b, near, SP_PERMS, device=torch.device("cpu"),
                               draw=injected(torch.device("cpu")))
    print(f"  against a noisy copy of the baseline: p = {p_card:.4f} on the "
          f"card, {p_cpu:.4f} on the CPU (injected signs)")
    check(p_card == p_cpu and 0.01 < p_card < 0.99, "the randomization "
          "test counts differently on the card and on the CPU")

    bd = quiet(read_letor_binned, paths["train"])[0]
    data = LambdaMART(n_leaves=N_LEAVES).prepare_fit(
        bd, create_scorer("NDCG@10"), None, dev)[2]
    hist, root = hist_point(data.binned_T, data.doc_mask)
    hist["shape"] = list(data.binned_T.shape) + [256]
    # the split scan on the streamed root histogram under integer gradients
    # (exact sums, so every output exact), unmasked and under a 30% mask
    F = root.shape[0]
    fmask = torch.from_numpy(np.random.default_rng(11).random((1, F))
                             < 0.3).to(dev)
    for fm in (None, fmask):
        check(all(torch.equal(a, b) for a, b in zip(
            SS.best_splits(root[None], 1.0, fm),
            SS.best_splits_plain(root[None], 1.0, fm))),
            "split scan on the streamed root histogram (integer gradients) "
            "differs from its plain version")
    print(f"  held against the plain versions on the runs' own tensors: "
          f"{held['split_scan']} split-scan calls (gains within the f32 "
          f"bound of the f64 scan, max_abs_err {scan_err:.3e} against it; "
          f"picks best within the bound; exact on the integer-rounded "
          f"histograms), "
          f"{held['forest_eval_frombins']} frombins calls (bit-equal); the "
          f"split scan on the streamed root histogram [{F}, 256] under "
          f"integer gradients: exact, with and without a feature mask")
    print(f"  histogram at the streamed shape {hist['shape']}: kernel "
          f"{hist['ms']:.4f} ms vs plain {hist['plain_ms']:.4f} ms, "
          f"index_add_ {hist['library_ms']:.4f} ms, bound "
          f"{hist['bound_ms']:.4f} ms ({hist['bound_by']}); max_abs_err "
          f"{hist['max_abs_err']:.3e}  [{smi}]")
    launches = {k: sum(r["launches"][k] for (_, m), r in runs.items()
                       if m == "sparse") for k in counters}
    launches["forest_eval_frombins"] += sum(
        v[1] for (_, m), v in scored.items() if m == "sparse")
    hist["launches"] = runs["6", "sparse"]["launches"]["histogram"]
    return {"launches": launches, "hist": hist, "loads": loads,
            "paths": paths, "ms_round": runs["6", "sparse"]["ms_round"],
            "ms_round_dense": runs["6", "dense"]["ms_round"],
            "ana_ms": ana_ms}


def write_letor(path, X, labels, qptr):
    # one %-format a document (the same text as a format a value)
    fmt = " ".join(f"{j + 1}:%.6g" for j in range(X.shape[1]))
    rows = X.tolist()
    with open(path, "w") as f:
        for q in range(len(qptr) - 1):
            for i in range(qptr[q], qptr[q + 1]):
                f.write(f"{int(labels[i])} qid:{q + 1} {fmt % tuple(rows[i])} "
                        f"# doc{q + 1}_{i - qptr[q]}\n")


# -sparse for the raw-value rankers (phase 19): RankLib's flags as phases
# 16-17 cut them, RankBoost to 100 rounds as the phase-16 CLI, and
# Coordinate Ascent further, to 1 restart, an 11-rung ladder and 1 sweep
# (-r 1 -i 10: a 700-coordinate sweep of the COO layer takes seconds)
RAW_CA = dict(n_restart=1, n_max_iteration=10, max_passes=1)
RAW_RB_ROUNDS, RAW_CPU_QUERIES = 100, 40
# the reference's own wide shape (tests/test_sparse_csr.py:709-741): 50,000
# features, 200 queries of 40 documents, 10 features a document
WIDE_FEATURES, WIDE_QUERIES, WIDE_DOCS, WIDE_PRESENT = 50_000, 200, 40, 10
BUDGET_ENV = "RANKLIB_TPU_DEVICE_DENSE_MB"


def raw_rankers():
    """(name, class, hyperparameters, takes validation) of the seven
    raw-value rankers at phase 19's cut."""
    from ranklib_tpu_torch.models.adarank import AdaRank
    from ranklib_tpu_torch.models.coorascent import CoorAscent
    from ranklib_tpu_torch.models.linear import LinearRegRank
    from ranklib_tpu_torch.models.neural import LambdaRank, ListNet, RankNet
    from ranklib_tpu_torch.models.rankboost import RankBoost

    return [("CoorAscent", CoorAscent, RAW_CA, True),
            ("RankBoost", RankBoost, dict(n_rounds=RAW_RB_ROUNDS,
                                          n_threshold=RB_TC), True),
            ("AdaRank", AdaRank, dict(n_rounds=ADA_ROUNDS), True),
            ("LinearRegression", LinearRegRank, {}, False),
            ("RankNet", RankNet, dict(n_epoch=NN_EPOCHS[0]), True),
            ("LambdaRank", LambdaRank, dict(n_epoch=NN_EPOCHS[1]), True),
            ("ListNet", ListNet, dict(n_epoch=NN_EPOCHS[2]), True)]


@contextlib.contextmanager
def budget(mb):
    """``RANKLIB_TPU_DEVICE_DENSE_MB`` set to ``mb`` inside the block
    (None: unset, the default 1,024)."""
    old = os.environ.pop(BUDGET_ENV, None)
    if mb is not None:
        os.environ[BUDGET_ENV] = str(mb)
    try:
        yield
    finally:
        os.environ.pop(BUDGET_ENV, None)
        if old is not None:
            os.environ[BUDGET_ENV] = old


@contextlib.contextmanager
def kept_prepare(cls, store: list):
    """Inside the block every ``cls.prepare_fit`` appends what it returns
    to ``store`` (the fit's device data, for holding B1 afterwards)."""
    orig = cls.prepare_fit

    def prepare(self, *args, **kw):
        out = orig(self, *args, **kw)
        store.append(out)
        return out

    cls.prepare_fit = prepare
    try:
        yield
    finally:
        cls.prepare_fit = orig


def fit_raw(cls, hp, train, vali, dev, scorer):
    """(ranker, wall s) of one fit, console captured."""
    r = cls(**hp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if cls.__name__ == "LinearRegRank":
        quiet(r.fit, train)
    else:
        quiet(r.fit, train, scorer, vali, device=dev)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def b1_hold(binsT, pot, B: int, what: str) -> dict:
    """B1 on a RankBoost fit's ids and pair potential against its plain
    version (counts exact, sums within HIST_TOL, two launches
    bit-identical), its own time by bare launches, the plain version's,
    ``index_add_``'s over the flat f*B + bin index, and the bound."""
    from ranklib_tpu_torch.ops import histogram as H

    F, N = binsT.shape
    dev = binsT.device
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    got = H.histogram(binsT, pot, ones, B)
    want = H.histogram_plain(binsT, pot, ones, B)
    torch.cuda.synchronize()
    check(torch.equal(got[..., 1], want[..., 1]),
          f"B1 counts differ from the plain version on {what}")
    check(torch.allclose(got[..., 0], want[..., 0], **HIST_TOL),
          f"B1 sums differ from the plain version on {what}")
    check(torch.equal(got, H.histogram(binsT, pot, ones, B)),
          f"B1 not reproducible on {what}")
    fn, args, keep = hist_bare(binsT, pot, ones.to(torch.float32), B)
    ms = bare_ms(fn, args)
    check(torch.equal(keep[0], got), f"the bare B1 launches on {what} "
                                     f"wrote another histogram")
    plain_ms = event_ms(lambda: H.histogram_plain(binsT, pot, ones, B), 3)
    idx = (torch.arange(F, device=dev)[:, None] * B
           + binsT.to(torch.int64)).reshape(-1)
    src = torch.stack([pot.expand(F, N).reshape(-1),
                       torch.ones(F * N, device=dev)], dim=-1)
    lib_ms = event_ms(lambda: torch.zeros((F * B, 2), device=dev).index_add_(
        0, idx, src), 10)
    del idx, src
    bnd = bound(nbytes(binsT, pot, ones, got), 2 * F * N)
    out = {"shape": [F, N, B], "max_abs_err": float((got - want).abs().max()),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
           "bound_by": bnd[1], "library_ms": lib_ms}
    print(f"  B1 on {what} [{F}, {N}] int16, B = {B}: max_abs_err "
          f"{out['max_abs_err']:.3e} (counts exact); kernel {ms:.4f} ms (20 "
          f"bare launches) vs plain {plain_ms:.4f} ms; index_add_ "
          f"{lib_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]})")
    return out


def raw_default_route(dev, paths, smi) -> dict:
    """Phase 18's 700-wide file on the default route (its dense [N, F]
    f32, ~167 MB, is under the device budget): each raw-value ranker fit
    on the dense file and on its host CSR, on the card; the models and
    the scores byte-equal. RankBoost's -sparse fit with the histogram
    counter at 0 (one B1 launch a round) and its ids equal to the dense
    fit's; B1 held on them. The CLI: -ranker 9 -norm zscore and -ranker 3
    with -validate -test, with and without -sparse (the same lines, the
    same model bytes, the fit handed a CSRDataset, no fallback); -load
    -test -sparse of the CA and RankNet models."""
    from ranklib_tpu_torch import cli, evaluator
    from ranklib_tpu_torch.data.letor import read_letor
    from ranklib_tpu_torch.data.sparse import read_letor_sparse
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models import rankboost as PRB
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops.sparse_eval import wants_sparse_eval

    scorer = create_scorer("NDCG@10")
    t0 = time.perf_counter()
    dense = read_letor(paths["train"], missing_zero=True)
    vdense = read_letor(paths["vali"], missing_zero=True,
                        n_features=dense.n_features).with_width(
        dense.n_features)
    t1 = time.perf_counter()
    csr = read_letor_sparse(paths["train"], quiet=True)
    vcsr = read_letor_sparse(paths["vali"], quiet=True,
                             n_features=csr.n_features)
    vcsr = vcsr.with_width(csr.n_features)
    print(f"  loads: dense {t1 - t0:.2f} s, CSR {time.perf_counter() - t1:.2f}"
          f" s ({csr.nnz} stored values, {csr.n_docs} docs x "
          f"{csr.n_features})")
    check(not wants_sparse_eval(csr), "the 700-wide file should take the "
                                      "default route")
    fits, out = {}, {"walls": {}}
    rb_data = []
    for name, cls, hp, val in raw_rankers():
        pair = {}
        for mode, tr, va in (("dense", dense, vdense), ("sparse", csr, vcsr)):
            va = va if val else None
            if name == "RankBoost" and mode == "sparse":
                H.histogram.launches = 0
                rounds = []
                with kept_prepare(PRB.RankBoost, rb_data), \
                        timed_steps(PRB.RankBoost, rounds):
                    pair[mode] = fit_raw(cls, hp, tr, va, dev, scorer)
                out["rb_launches"] = H.histogram.launches
                check(out["rb_launches"] == len(rounds) > 0,
                      "RankBoost -sparse did not launch B1 once a round")
                out["rb_rounds"] = len(rounds)
            elif name == "RankBoost":
                with kept_prepare(PRB.RankBoost, rb_data):
                    pair[mode] = fit_raw(cls, hp, tr, va, dev, scorer)
            elif name == "CoorAscent":
                with timed_steps(cls, out.setdefault("ca_sweeps", {})
                                 .setdefault(mode, [])):
                    pair[mode] = fit_raw(cls, hp, tr, va, dev, scorer)
            else:
                pair[mode] = fit_raw(cls, hp, tr, va, dev, scorer)
        (rd, wd), (rs, ws) = pair["dense"], pair["sparse"]
        check(rd.model_str() == rs.model_str(),
              f"{name}: the -sparse fit's model differs from the dense fit's")
        sd, ss = rd.eval_dataset(dense, dev), rs.eval_dataset(csr, dev)
        check(all(np.array_equal(a, b) for a, b in zip(sd, ss)),
              f"{name}: the CSR scores differ from the dense scores")
        fits[name] = rd
        out["walls"][name] = (wd, ws)
        print(f"  {name} {hp}: dense {wd:.2f} s, -sparse {ws:.2f} s: the "
              f"same model bytes and scores")
    (_, _, dd, _), (step, state, sd, _) = rb_data[0], rb_data[1]
    check(torch.equal(dd.binned_T, sd.binned_T),
          "RankBoost's CSR ids differ from the dense ids on the card")
    rb = fits["RankBoost"]
    pot = PRB.pair_potential(rb.fit_state.scores, sd.tb, sd.uniq,
                             sd.binned_T.shape[1])
    out["b1"] = b1_hold(sd.binned_T, pot, RB_TC + 1,
                        f"the 700-wide -sparse fit's ids (round "
                        f"{out['rb_rounds']}'s pi)")
    out["b1"]["launches"] = out["rb_launches"]
    del rb_data

    seen = []
    orig = evaluator.train_ranker

    def recording(ranker_type, train, *a, **k):
        seen.append(type(train).__name__)
        return orig(ranker_type, train, *a, **k)

    evaluator.train_ranker = recording
    try:
        for ranker, flags in (("9", ["-norm", "zscore"]),
                              ("3", ["-round", str(ADA_ROUNDS)])):
            got = {}
            for mode in ("dense", "sparse"):
                model = os.path.join(os.path.dirname(paths["train"]),
                                     f"raw{ranker}_{mode}.txt")
                seen.clear()
                t0 = time.perf_counter()
                rc, text = quiet(cli.main, [
                    "-train", paths["train"], "-ranker", ranker, *flags,
                    "-metric2t", "NDCG@10", "-validate", paths["vali"],
                    "-test", paths["vali"], "-missingZero", "-save", model,
                    *(["-sparse"] if mode == "sparse" else [])])
                check(rc == 0, f"-train -ranker {ranker} ({mode}) failed:\n"
                               f"{text[-2000:]}")
                with open(model) as f:
                    got[mode] = ([ln for ln in text.splitlines()
                                  if " on " in ln and "data:" in ln],
                                 f.read(), list(seen), text,
                                 time.perf_counter() - t0)
            check(got["dense"][:2] == got["sparse"][:2],
                  f"-ranker {ranker} -sparse printed other lines or saved "
                  f"another model")
            check(got["sparse"][2] == ["CSRDataset"]
                  and "not applicable" not in got["sparse"][3],
                  f"-ranker {ranker} -sparse fell back ({got['sparse'][2]})")
            print(f"  CLI -ranker {ranker} {' '.join(flags)} -validate -test:"
                  f" dense {got['dense'][4]:.1f} s, -sparse "
                  f"{got['sparse'][4]:.1f} s, the same lines "
                  f"({'; '.join(got['sparse'][0])}) and model bytes")
    finally:
        evaluator.train_ranker = orig
    for name in ("CoorAscent", "RankNet"):
        model = os.path.join(os.path.dirname(paths["train"]),
                             f"raw_{name}.txt")
        fits[name].save(model)
        lines = []
        for extra in ([], ["-sparse"]):
            rc, text = quiet(cli.main, [
                "-load", model, "-test", paths["train"], "-metric2T",
                "NDCG@10", "-missingZero", *extra])
            check(rc == 0, f"-load -test of the {name} model failed")
            lines.append([ln for ln in text.splitlines()
                          if " on test data" in ln])
        check(lines[0] == lines[1] and len(lines[0]) == 1,
              f"-load -test -sparse of the {name} model printed another "
              f"line")
        print(f"  -load ({name}) -test -sparse: {lines[1][0]}, as dense")
    print(f"  [{smi}]")
    out.update(csr=csr, vcsr=vcsr, dense=dense, vdense=vdense, fits=fits)
    return out


def raw_coo_route(dev, raw, smi) -> dict:
    """The same file under RANKLIB_TPU_DEVICE_DENSE_MB=0: Coordinate Ascent
    (-r 1 -i 10, 1 sweep), AdaRank and the three nets through the COO
    layer, each twice (bit-identical models), against the dense fits
    within the reference's tolerances: CA weights 2e-5, AdaRank's picks
    identical and alphas 2e-5, the nets' parameters 1e-6. The sweep's
    wall beside the dense one's, and the COO layer's device time."""
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models import coorascent as PCA
    from ranklib_tpu_torch.models import neural as PN
    from ranklib_tpu_torch.ops import sparse_eval as SE

    scorer = create_scorer("NDCG@10")
    csr, vcsr = raw["csr"], raw["vcsr"]
    calls = {"segment_rows": 0, "sparse_rows": 0}
    origs = {"segment_rows": SE.segment_rows, "sparse_rows": PN.sparse_rows}

    def counting(mod, name):
        def fn(*a, **k):
            calls[name] += 1
            return origs[name](*a, **k)
        setattr(mod, name, fn)

    sweeps = {"dense": raw["ca_sweeps"]["dense"]}
    out = {"walls": {}}
    counting(SE, "segment_rows")
    counting(PN, "sparse_rows")
    try:
        with budget(0):
            check(SE.wants_sparse_eval(csr), "a budget of 0 should route "
                                             "the CSR to the COO layer")
            for name, cls, hp, val in raw_rankers():
                if name in ("RankBoost", "LinearRegression"):
                    continue
                want = raw["fits"][name]
                runs = []
                for _ in range(2):
                    before = dict(calls)
                    times = sweeps.setdefault("coo", []) \
                        if name == "CoorAscent" else []
                    with timed_steps(cls, times):
                        runs.append(fit_raw(cls, hp, csr,
                                            vcsr if val else None, dev,
                                            scorer))
                    used = ("sparse_rows" if name in (
                        "RankNet", "LambdaRank", "ListNet")
                        else "segment_rows")
                    check(calls[used] > before[used], f"{name} did not take "
                                                      f"the COO route")
                (a, wa), (b, wb) = runs
                check(a.model_str() == b.model_str(), f"{name}: two COO "
                      f"fits on the card are not bit-identical")
                if name == "CoorAscent":
                    err = float(np.abs(a.weights - want.weights).max())
                    check(err <= 2e-5, f"CA on the COO route: weights off "
                                       f"the dense fit's by {err:.2e}")
                elif name == "AdaRank":
                    check([f for f, _ in a.history]
                          == [f for f, _ in want.history],
                          "AdaRank on the COO route picked other features")
                    err = max((abs(x - y) for (_, x), (_, y) in zip(
                        a.history, want.history)), default=0.0)
                    check(err <= 2e-5, f"AdaRank on the COO route: alphas "
                                       f"off by {err:.2e}")
                else:
                    err = max(float(np.abs(x - y).max())
                              for pa, pb in zip(a.params, want.params)
                              for x, y in zip(pa, pb))
                    check(err <= 1e-6, f"{name} on the COO route: parameters "
                                       f"off the dense fit's by {err:.2e}")
                out["walls"][name] = (wa, wb)
                out.setdefault("models", {})[name] = a
                print(f"  {name} COO: {wa:.2f} s and {wb:.2f} s, "
                      f"bit-identical; off the dense fit by {err:.2e}")
            # the layer alone: CA's candidate count at RankLib's -r 5 -i 25
            # (260) and AdaRank's strong model (1)
            chunks, buckets, N = SE.build_sparse_data(csr, dev)
            ent = sum(c[0].numel() for c in chunks)
            layer = {}
            for K in (260, 22, 1):
                W = torch.from_numpy(np.random.default_rng(K).normal(
                    size=(csr.n_features, K)).astype(np.float32)).to(dev)
                layer[K] = (
                    event_ms(lambda: SE.sparse_scores_flat(W, chunks, N), 5),
                    event_ms(lambda: SE.sparse_mean_metric(
                        scorer, W, chunks, buckets, N, len(csr.queries)), 3))
    finally:
        SE.segment_rows = origs["segment_rows"]
        PN.sparse_rows = origs["sparse_rows"]
    out["layer"] = layer
    out["entries"] = ent
    out["ms_sweep"] = {k: float(np.median(v)) for k, v in sweeps.items()}
    print(f"  Coordinate Ascent -r 1 -i 10, a sweep of {csr.n_features} "
          f"coordinates: dense {out['ms_sweep']['dense']:.1f} ms, COO "
          f"{out['ms_sweep']['coo']:.1f} ms (median)")
    print("  COO layer, " + f"{ent} entries in {len(chunks)} chunks: "
          + "; ".join(f"K = {K}: scores {a:.3f} ms, mean metric {b:.3f} ms"
                      for K, (a, b) in layer.items()) + f"  [{smi}]")
    return out


def raw_card_vs_cpu(dev, raw) -> None:
    """The first 40 queries of the 700-wide CSR on the CPU and on the card
    (default route): RankBoost's first 20 weak rankers identical, alphas
    within 1e-4 relative; Coordinate Ascent (-r 1 -i 10, 1 sweep) and the
    nets (1 epoch at 10x RankLib's rates, the same seeded draws) within
    1e-5; AdaRank's first 20 picks identical; Linear Regression's scores
    within 1e-5 of the CPU's."""
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models import neural as PN
    from ranklib_tpu_torch.models.adarank import AdaRank
    from ranklib_tpu_torch.models.coorascent import CoorAscent
    from ranklib_tpu_torch.models.linear import LinearRegRank
    from ranklib_tpu_torch.models.rankboost import RankBoost

    sub = raw["csr"].subset_queries(range(RAW_CPU_QUERIES))
    scorer = create_scorer("NDCG@10")
    cpu = torch.device("cpu")
    fits = []
    for d in (cpu, dev):
        t0 = time.perf_counter()
        f = {}
        fits.append(f)
        f["rb"] = fit_raw(RankBoost, dict(n_rounds=20, n_threshold=RB_TC),
                          sub, None, d, scorer)[0].weaks
        f["ca"] = fit_raw(CoorAscent, RAW_CA, sub, None, d,
                          scorer)[0].weights
        f["ada"] = [x for x, _ in fit_raw(AdaRank, dict(n_rounds=20), sub,
                                          None, d, scorer)[0].history]
        for cls in (PN.RankNet, PN.LambdaRank, PN.ListNet):
            r = cls(n_epoch=1)
            r.learning_rate *= 10
            quiet(r.fit, sub, scorer, device=d)
            f[cls.NAME] = r.params
        lin = LinearRegRank()
        lin.fit(sub)
        f["lin"] = np.concatenate(lin.eval_dataset(sub, d))
        print(f"  {d.type}: the seven rankers on {RAW_CPU_QUERIES} queries x "
              f"{sub.n_features} (CSR) in {time.perf_counter() - t0:.1f} s")
    c, g = fits
    check([w[:2] for w in c["rb"]] == [w[:2] for w in g["rb"]]
          and len(c["rb"]) == 20, "RankBoost's weak rankers differ card vs "
                                  "CPU on the CSR")
    alpha = max(abs(a[2] - b[2]) / abs(a[2]) for a, b in zip(c["rb"], g["rb"]))
    check(alpha <= 1e-4, "RankBoost's alphas differ card vs CPU on the CSR")
    ca = float(np.abs(c["ca"] - g["ca"]).max())
    check(ca <= 1e-5, "Coordinate Ascent differs card vs CPU on the CSR")
    check(c["ada"] == g["ada"], "AdaRank's picks differ card vs CPU on the "
                                "CSR")
    nets = {n: max(float(np.abs(a - b).max()) for pa, pb in zip(c[n], g[n])
                   for a, b in zip(pa, pb))
            for n in ("RankNet", "LambdaRank", "ListNet")}
    check(max(nets.values()) <= 1e-5, f"the nets differ card vs CPU on the "
                                      f"CSR: {nets}")
    lin = float(np.abs(c["lin"] - g["lin"]).max())
    check(lin <= 1e-5, "Linear Regression's scores differ card vs CPU")
    print(f"  card vs CPU: RankBoost's 20 weak rankers identical (alphas "
          f"{alpha:.2e} relative), CA {ca:.2e}, AdaRank's {len(c['ada'])} "
          f"picks identical, nets " + ", ".join(
              f"{k} {v:.2e}" for k, v in nets.items())
          + f", Linear Regression's scores {lin:.2e}")


# AdaRank -round 5, RankNet -epoch 1 and RankBoost -round 20 -tc 10 through
# the CLI with -sparse on the wide file, in a process of its own: the wall,
# the host peak RSS above the process (VmRSS sampled every millisecond), the
# histogram launches, and the dataset type and route the fit was handed.
# The same three flows first run on the file's first 2 queries under a
# budget of 0 (the same COO route): the CUDA libraries load their kernels
# into host memory at first use, and the RSS above that is the data's
_WIDE_CODE = """
import json, os, sys, threading, time
sys.path.insert(0, sys.argv[1])
import torch
from ranklib_tpu_torch import cli, evaluator
from ranklib_tpu_torch.ops import histogram as H
from ranklib_tpu_torch.ops.sparse_eval import wants_sparse_eval
torch.zeros(1, device='cuda')
def rss():
    with open('/proc/self/status') as f:
        return next(int(ln.split()[1]) * 1024 for ln in f
                    if ln.startswith('VmRSS:'))
seen = []
orig = evaluator.train_ranker
def recording(ranker_type, train, *a, **k):
    seen.append([type(train).__name__, wants_sparse_eval(train)])
    return orig(ranker_type, train, *a, **k)
evaluator.train_ranker = recording
os.environ['RANKLIB_TPU_DEVICE_DENSE_MB'] = '0'
for ranker, flags in json.loads(sys.argv[3]):
    assert cli.main(['-train', sys.argv[5], '-ranker', ranker, *flags,
                     '-metric2t', 'NDCG@10', '-missingZero', '-sparse',
                     '-silent']) == 0
del os.environ['RANKLIB_TPU_DEVICE_DENSE_MB']
seen.clear()
start = rss()
runs = []
for ranker, flags in json.loads(sys.argv[3]):
    model = os.path.join(sys.argv[4], 'wide' + ranker + '.txt')
    before = rss()
    peak = [before]
    done = threading.Event()
    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], rss())
            time.sleep(0.001)
    sampler = threading.Thread(target=sample)
    sampler.start()
    H.histogram.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(['-train', sys.argv[2], '-ranker', ranker, *flags,
                   '-metric2t', 'NDCG@10', '-missingZero', '-sparse',
                   '-save', model])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done.set()
    sampler.join()
    with open(model) as f:
        head = f.readline().strip()
    runs.append({'ranker': ranker, 'rc': rc, 's': wall, 'before': before,
                 'peak': max(peak[0], rss()), 'start': start,
                 'launches': H.histogram.launches, 'seen': seen[-1:],
                 'head': head})
print(json.dumps(runs))
"""


def write_wide(path) -> tuple:
    """The reference's wide shape as a LETOR file: 200 queries of 40 docs,
    10 distinct features of 50,000 a doc, N(0,1) values, labels 0-2
    (seeded); returns (docs, features)."""
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for q in range(WIDE_QUERIES):
            for i in range(WIDE_DOCS):
                fids = np.sort(rng.choice(WIDE_FEATURES, WIDE_PRESENT,
                                          replace=False))
                fids[-1] = WIDE_FEATURES - 1 if q == i == 0 else fids[-1]
                pairs = " ".join(f"{fid + 1}:{rng.normal():.4g}"
                                 for fid in fids)
                f.write(f"{int(rng.integers(0, 3))} qid:{q + 1} {pairs} "
                        f"# w{q + 1}_{i}\n")
    return WIDE_QUERIES * WIDE_DOCS, WIDE_FEATURES


def wide_phase(dev, tmp, smi) -> dict:
    """The reference's wide shape, whose dense [N, F] f32 (1.6 GB) is over
    the device budget, so the default route is COO: AdaRank -round 5,
    RankNet -epoch 1 and RankBoost -round 20 -tc 10 through the CLI with
    -sparse in a process of its own (wall, host peak RSS above the
    process, B1 launches: 20); then B1 held on RankBoost's [50,000,
    8,000] int16 ids."""
    from ranklib_tpu_torch.data.sparse import read_letor_sparse
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models import rankboost as PRB

    path = os.path.join(tmp, "wide.txt")
    t0 = time.perf_counter()
    N, F = write_wide(path)
    warm = os.path.join(tmp, "wide_warm.txt")
    with open(path) as f, open(warm, "w") as g:
        g.writelines(ln for ln in f if ln.split()[1] in ("qid:1", "qid:2"))
    dense_gb = N * F * 4 / 1e9
    print(f"  wrote {WIDE_QUERIES} queries x {WIDE_DOCS} docs x {F} features"
          f" ({WIDE_PRESENT} present a doc; {os.path.getsize(path) / 2**20:.1f}"
          f" MiB; dense f32 {dense_gb:.2f} GB) in "
          f"{time.perf_counter() - t0:.1f} s")
    root = os.path.dirname(os.path.abspath(__file__))
    flows = [["3", ["-round", "5"]], ["1", ["-epoch", "1"]],
             ["2", ["-round", "20", "-tc", str(RB_TC)]]]
    proc = subprocess.run([sys.executable, "-c", _WIDE_CODE, root, path,
                           json.dumps(flows), tmp, warm],
                          capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"the wide runs failed:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    check("not applicable" not in proc.stdout, "a wide run fell back")
    heads = {"3": "## AdaRank", "1": "## RankNet", "2": "## RankBoost"}
    for r in runs:
        above = (r["peak"] - r["start"]) / 2**20
        print(f"  -ranker {r['ranker']} -sparse: {r['s']:.2f} s wall, host "
              f"peak RSS {r['peak'] / 2**20:.1f} MiB, {above:.1f} MiB above "
              f"the process after the warm-up ({(r['peak'] - r['before']) / 2**20:.1f}"
              f" MiB above it before this run); fit handed {r['seen']}; B1 "
              f"launches {r['launches']}")
        check(r["rc"] == 0 and r["head"] == heads[r["ranker"]],
              f"-ranker {r['ranker']} on the wide file failed")
        check(r["seen"] == [["CSRDataset", True]] or r["ranker"] == "2",
              f"-ranker {r['ranker']}: the wide fit did not take the COO "
              f"route")
        check(r["peak"] - r["start"] < 0.5 * N * F * 4,
              f"-ranker {r['ranker']}: host memory above half the dense "
              f"[N, F] f32")
    rb = [r for r in runs if r["ranker"] == "2"][0]
    check(rb["launches"] == 20, "the wide RankBoost fit did not launch B1 "
                                "20 times")
    ds = read_letor_sparse(path, quiet=True)
    step, state, data, _ = PRB.RankBoost(
        n_rounds=20, n_threshold=RB_TC).prepare_fit(
        ds, create_scorer("NDCG@10"), None, dev)
    for t in range(3):
        state = step(state, t, data)
    pot = PRB.pair_potential(state.scores, data.tb, data.uniq, N)
    b1 = b1_hold(data.binned_T, pot, RB_TC + 1, "the wide file's ids (round "
                                                "4's pi)")
    b1["launches"] = rb["launches"]
    del data, state
    torch.cuda.empty_cache()
    print(f"  [{smi}]")
    return {"runs": runs, "b1": b1,
            "peak_above": max(r["peak"] - r["start"] for r in runs)}

# phase 20: the extensions at the training width — a 20-tree LambdaMART
# (-ckpt 10; a 10-tree checkpoint resumed to 20), -dp 2 as two gloo ranks
# on the one card, a 4-bag Random Forest under -dp 2
EXT_TREES, EXT_CKPT, EXT_BAGS = 20, 10, 4


def round_ms(path: str) -> float:
    """Median ms between consecutive ``"round"`` records of an event log
    (a fit's own clock: rank 0's under ``-dp``)."""
    t = [json.loads(ln)["t"] for ln in open(path)
         if json.loads(ln)["event"] == "round"]
    return float(np.median(np.diff(t))) * 1e3


def trace_kernels(prof: str) -> set:
    """Names of the CUDA kernels in the torch.profiler traces of ``prof``."""
    import glob

    names = set()
    for path in glob.glob(os.path.join(prof, "*.pt.trace.json")):
        with open(path) as f:
            names |= {e.get("name", "") for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "kernel"}
    return names


def counts():
    from ranklib_tpu_torch.models.gbdt import launch_counts

    return launch_counts()


def zero_counts():
    from ranklib_tpu_torch.ops import forest_eval as fe
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import lambda_kernel as LK
    from ranklib_tpu_torch.ops import split_scan as SS

    H.histogram.launches = SS.best_splits.launches = 0
    LK.lambda_round.launches = fe.forest_eval_frombins.launches = 0
    H.histogram_multi.launches = 0


@contextlib.contextmanager
def holding(n_hold: int, scans: bool, rank: int):
    """Inside the block, this process's first ``n_hold`` histogram
    launches of the tree growth held against the plain version on the
    very card tensors they were given (counts exact, sums within
    HIST_TOL, the root document count kept); with ``scans``, its first
    split-scan launch too (:func:`hold_scans`, on the summed histograms
    it was given). Yields the two lists the findings go to; the held
    launches count nowhere."""
    from ranklib_tpu_torch.gbdt import grow
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.ops import split_scan as SS

    orig, orig_scan, held, scan_err = grow.histogram, grow.best_splits, [], []

    def hist(binsT, grad, w, B):
        got = orig(binsT, grad, w, B)
        if len(held) < n_hold:
            want = H.histogram_plain(binsT, grad, w, B)
            held.append({
                "shape": [*binsT.shape, B], "dtype": str(binsT.dtype),
                "device": str(got.device),
                "counts_equal": bool(torch.equal(got[..., 1], want[..., 1])),
                "sums_close": bool(torch.allclose(got[..., 0], want[..., 0],
                                                  **HIST_TOL)),
                "max_abs_err": float((got - want).abs().max()),
                "docs": float(got[0, :, 1].sum()),
                "zero": not bool(got.any())})
        return got

    def scan(*a, **kw):
        got = orig_scan(*a, **kw)
        if scans and not scan_err:
            n = SS.best_splits.launches
            scan_err.append(hold_scans([(a, kw, got)], f"rank {rank}"))
            SS.best_splits.launches = n
        return got

    grow.histogram, grow.best_splits = hist, scan
    try:
        yield held, scan_err
    finally:
        grow.histogram, grow.best_splits = orig, orig_scan


def _held_rank(fn, n_hold, out_dir, scans, rank, device, group, *args):
    """A ``-dp`` rank's ``fn`` with its first ``n_hold`` histogram launches
    (the first tree's root and right children) and, with ``scans``, its
    first split-scan launch held (:func:`holding`). The findings go to
    ``out_dir/rank<r>.json`` for the parent to check, and ``fn``'s result
    is returned untouched."""
    with holding(n_hold, scans, rank) as (held, scan_err):
        out = fn(rank, device, group, *args)
    if scans:
        held = {"hist": held, "scan_err": scan_err}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(held, f)
    return out


@contextlib.contextmanager
def held_ranks(n_ranks: int, n_hold: int, tmp: str, calls: list,
               scans: list | None = None):
    """Inside the block every ``-dp`` run's ranks go through
    :func:`_held_rank`; at its end each rank's findings are appended to
    ``calls`` (a list of held launches a rank) and checked: ``n_hold``
    launches a rank, each on the card, counts exact and sums within
    HIST_TOL of the plain version. With ``scans`` (a list) each rank
    also holds its first split-scan launch, and its gain gap is appended
    there. The rank function must pickle by name, so it is taken from
    this script imported as a module."""
    import functools
    import importlib

    from ranklib_tpu_torch.parallel import dist

    me = importlib.import_module("chip_smoke")
    out_dir = tempfile.mkdtemp(dir=tmp)
    orig = dist.run

    def run(mesh, fn, *args, **kw):
        return orig(mesh, functools.partial(me._held_rank, fn, n_hold,
                                            out_dir, scans is not None),
                    *args, **kw)

    dist.run = run
    try:
        yield
    finally:
        dist.run = orig
    for r in range(n_ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            found = json.load(f)
        if scans is not None:
            check(len(found["scan_err"]) == 1,
                  f"rank {r} held no split-scan launch")
            scans.append(found["scan_err"][0])
            found = found["hist"]
        calls.append(found)
        check(len(calls[r]) == n_hold,
              f"rank {r} held {len(calls[r])} histogram launches, not "
              f"{n_hold}")
        check(all(c["device"].startswith("cuda") for c in calls[r]),
              f"rank {r}'s histograms were not on the card")
        check(all(c["counts_equal"] and c["sums_close"] for c in calls[r]),
              f"rank {r}'s histogram differs from the plain version on its "
              f"own shard: {calls[r]}")


def metric_line(out: str, what: str = "training") -> str:
    lines = [ln for ln in out.splitlines() if f" on {what} data: " in ln]
    check(len(lines) == 1, f"no '{what} data' line:\n{out[-2000:]}")
    return lines[0]


def extensions_phase(dev, fit, tmp, smi) -> dict:
    """Phase 20 on phase 5's training set, through the CLI, the fits' own
    ``mesh`` argument and the library API (each part with the launch
    counters at 0): -ckpt, -eventlog and -profile; -resume; -dp 2 as two
    gloo ranks on the card; the CLI's -dp 2 (one card: the single-device
    fit); Random Forests under -dp 2; api.train and api.evaluate."""
    from ranklib_tpu_torch import api, cli
    from ranklib_tpu_torch.gbdt import ensemble as ens_mod
    from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
    from ranklib_tpu_torch.models import gbdt as G
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.models.rf import RFRanker
    from ranklib_tpu_torch.ops import histogram as H
    from ranklib_tpu_torch.parallel import dist
    from ranklib_tpu_torch.utils.logging import set_event_log

    t0 = time.perf_counter()
    train_path = os.path.join(tmp, "p20_train.txt")
    write_dataset(train_path, fit["train"])
    print(f"  wrote the training set as LETOR text in "
          f"{time.perf_counter() - t0:.1f} s")
    base = ["-train", train_path, "-ranker", "6", "-metric2t", "NDCG@10",
            "-leaf", str(N_LEAVES)]
    want = EXT_TREES * (N_LEAVES - 1)
    out = {}

    # -ckpt, -eventlog, -profile
    m, ev, prof = (os.path.join(tmp, f"p20_{x}") for x in ("m.txt", "ev",
                                                           "prof"))
    zero_counts()
    rc, text = quiet(cli.main, [*base, "-tree", str(EXT_TREES), "-ckpt",
                                str(EXT_CKPT), "-save", m, "-eventlog", ev,
                                "-profile", prof])
    torch.cuda.synchronize()
    c = counts()
    check(rc == 0, f"-ckpt -eventlog -profile failed:\n{text[-2000:]}")
    print(f"  -tree {EXT_TREES} -ckpt {EXT_CKPT} -eventlog -profile: "
          f"{metric_line(text)}; launches {c}")
    check(c["histogram"] == want and c["split_scan"] == want,
          f"B1/B2 launches are not {EXT_TREES} x {N_LEAVES - 1}")
    check(c["lambda_pairs"] == 0, "the default route launched B5")
    check(open(m + ".ckpt").read() == open(m).read(),
          "the last checkpoint is not the saved model")
    recs = [json.loads(ln) for ln in open(ev)]
    table = [ln.split("|")[1].strip() for ln in text.splitlines()
             if ln[:1].isdigit() and "|" in ln]
    check(len(recs) == EXT_TREES
          and [r["round"] for r in recs] == list(range(1, EXT_TREES + 1))
          and [f"{r['train_metric']:.4f}" for r in recs] == table,
          "the event log's rounds are not the printed table")
    kern = trace_kernels(prof)
    hist_k = sorted(k for k in kern if "columns_kernel" in k)
    scan_k = sorted(k for k in kern if "split_scan_kernel" in k)
    print(f"  {len(recs)} round records equal to the table; the trace holds "
          f"{len(kern)} kernel names, B1's {hist_k[:1]}, B2's {scan_k[:1]}")
    check(hist_k and scan_k, "the trace lacks B1's or B2's kernel")
    out["ckpt"] = c

    # -resume of a 10-tree checkpoint up to 20 trees
    m10 = os.path.join(tmp, "p20_m10.txt")
    rc, _ = quiet(cli.main, [*base, "-tree", str(EXT_CKPT), "-ckpt",
                             str(EXT_CKPT), "-save", m10])
    check(rc == 0 and open(m10 + ".ckpt").read() == open(m10).read(),
          "the 10-tree checkpoint run failed")
    mres = os.path.join(tmp, "p20_resumed.txt")
    zero_counts()
    fb_calls = []
    with kept_calls(ens_mod, "forest_eval_frombins", fb_calls):
        rc, text_r = quiet(cli.main, [*base, "-tree", str(EXT_TREES),
                                      "-resume", m10 + ".ckpt", "-save",
                                      mres])
    torch.cuda.synchronize()
    c = counts()
    check(rc == 0, f"-resume failed:\n{text_r[-2000:]}")
    warm = [ln for ln in text_r.splitlines() if ln.startswith("Warm start")]
    prior = open(m10).read().split("</tree>")[:EXT_CKPT]
    kept = open(mres).read().split("</tree>")[:EXT_CKPT]
    strip = lambda trees: [t[t.find("<tree"):] for t in trees]
    m_straight = float(metric_line(text).split()[-1])
    m_resumed = float(metric_line(text_r).split()[-1])
    print(f"  -resume: {warm}; launches {c}; prior trees kept verbatim: "
          f"{strip(kept) == strip(prior)}; NDCG@10 {m_resumed:.4f} vs "
          f"straight {m_straight:.4f}")
    check(warm == [f"Warm start from {EXT_CKPT} trees "
                   f"({EXT_TREES - EXT_CKPT} rounds to go)"],
          "no warm-start line")
    check(strip(kept) == strip(prior), "the prior trees were not kept")
    check(c["histogram"] == (EXT_TREES - EXT_CKPT) * (N_LEAVES - 1),
          "B1 launches of the resumed fit are not 10 x 9")
    check(c["forest_eval_frombins"] > 0, "the warm start did not launch B4")
    check(len(fb_calls) == c["forest_eval_frombins"],
          "a B4 launch of the resumed fit was not kept")
    hold_frombins(fb_calls, "the -resume warm start")
    print(f"  the resumed fit's {len(fb_calls)} B4 launches (ids "
          f"{[list(a[0].shape) for a, _, _ in fb_calls]}, trees "
          f"{[int(a[1].split_roots.numel()) for a, _, _ in fb_calls]}) "
          f"bit-equal to the plain version")
    del fb_calls
    check(abs(m_resumed - m_straight) <= 0.05,
          "the resumed fit is more than 0.05 off the straight fit")
    out["resume"] = c

    # -dp 2: two gloo ranks on the one card, beside the single-device fit
    scorer = create_scorer("NDCG@10")
    hp = dict(n_trees=EXT_TREES, n_leaves=N_LEAVES, early_stop=0)
    single, ev_1 = LambdaMART(**hp), os.path.join(tmp, "p20_ev1")
    set_event_log(ev_1)
    quiet(single.fit, fit["train"], scorer, device=dev)
    set_event_log(None)
    mesh = dist.Mesh((dev, dev), "gloo")
    seen = []
    check_models = G.check_same_models

    def keep(ensembles):
        seen.append(len({e.to_text() for e in ensembles}))
        check_models(ensembles)

    G.check_same_models = keep
    meshed, ev_2 = LambdaMART(**hp), os.path.join(tmp, "p20_ev2")
    zero_counts()
    set_event_log(ev_2)
    held = []
    try:
        with held_ranks(mesh.size, N_LEAVES - 1, tmp, held):
            t1 = time.perf_counter()
            _, text_d = quiet(meshed.fit, fit["train"], scorer, device=dev,
                              mesh=mesh)
            wall_dp = time.perf_counter() - t1
    finally:
        set_event_log(None)
        G.check_same_models = check_models
    ranks = meshed.rank_launches
    parent = counts()
    n_docs = sum(q.n for q in fit["train"].queries)
    root_docs = [calls[0]["docs"] for calls in held]
    b1_err = max(c["max_abs_err"] for calls in held for c in calls)
    print(f"  -dp 2: each rank's first {N_LEAVES - 1} B1 launches (the first "
          f"tree) held against the plain version on its own shard "
          f"{held[0][0]['shape']} {held[0][0]['dtype']}: counts exact, sums "
          f"max_abs_err {b1_err:.3e} (HIST_TOL); the ranks' roots count "
          f"{root_docs} of the {n_docs} training documents")
    check(sum(root_docs) == n_docs,
          "the ranks' root histograms do not count every training document "
          "once")
    # B1 timed alone at a rank's shape: rank 0's shard of the same bins,
    # built here (in the fit the two ranks share the card)
    from ranklib_tpu_torch.gbdt.boost_dist import build_sharded_data
    from ranklib_tpu_torch.gbdt.binning import bin_features

    feats, _, _, thr, binned, _, _ = G.flatten_binned(fit["train"], 256)
    if binned is None:
        binned = bin_features(feats, thr)
    shard, _, _ = build_sharded_data(fit["train"], binned, mesh.size, 0,
                                     dev)
    print(f"  B1 alone on rank 0's shard {list(shard.binned_T.shape)} "
          f"{shard.binned_T.dtype}:")
    b1_shard, _ = hist_point(shard.binned_T, shard.doc_mask, 256)
    print(f"    {b1_shard['ms']:.4f} ms vs plain {b1_shard['plain_ms']:.4f}, "
          f"index_add_ {b1_shard['library_ms']:.4f}, bound "
          f"{b1_shard['bound_ms']:.4f} ({b1_shard['bound_by']})  [{smi}]")
    del feats, binned, shard
    m_single, _ = score_dataset(scorer, fit["train"], single.eval_dataset(
        fit["train"], dev), dev)
    m_dp, _ = score_dataset(scorer, fit["train"], meshed.eval_dataset(
        fit["train"], dev), dev)
    t_s, t_d = single.ensemble.trees[0], meshed.ensemble.trees[0]
    first_same = all(np.array_equal(getattr(t_s, f), getattr(t_d, f))
                     for f in ("feature", "threshold", "left", "right"))
    ms_1, ms_2 = round_ms(ev_1), round_ms(ev_2)
    print(f"  -dp 2 (gloo, 2 ranks on {torch.cuda.get_device_name(0)}): "
          f"fit wall {wall_dp:.1f} s with rank start-up; rank launches "
          f"{ranks}; the parent's B1 {parent['histogram']}; ranks' models "
          f"equal: {seen == [1]}")
    print(f"    first tree: single-device features "
          f"{t_s.feature[~t_s.is_leaf].tolist()}, -dp "
          f"{t_d.feature[~t_d.is_leaf].tolist()}; the same structure and "
          f"thresholds: {first_same}")
    print(f"    ms a round (event log, median): single device {ms_1:.3f}, "
          f"-dp 2 {ms_2:.3f}; train NDCG@10 {m_single:.6f} vs {m_dp:.6f}  "
          f"[{smi}]")
    check(seen == [1], "the ranks' models differ")
    check(first_same, "the -dp fit's first tree is not the single-device "
                      "fit's")
    check(all(r["histogram"] == want and r["split_scan"] == want
              for r in ranks), "a rank's B1/B2 launches are not 20 x 9")
    check(parent["histogram"] == 0, "the parent grew trees under -dp")
    check(abs(m_single - m_dp) <= 0.03,
          "the -dp fit is more than 0.03 off the single-device fit")
    from ranklib_tpu_torch.gbdt.boost_dist import _shard_queries

    n0 = sum(fit["train"].queries[qi].n
             for qi in _shard_queries(fit["train"], 2)[0])
    out["dp"] = {"ranks": ranks, "ms_round": ms_2, "ms_round_single": ms_1,
                 "first_tree_same": first_same, "wall_s": wall_dp,
                 "b1_max_abs_err": b1_err, "b1_shard": b1_shard,
                 "shape": [N_FEATURES, G._pad_doc_count(n0), 256]}

    # the CLI's -dp 2 on this machine
    mdp = os.path.join(tmp, "p20_dp.txt")
    rc, text_c = quiet(cli.main, [*base, "-tree", str(EXT_TREES), "-dp",
                                  "2", "-save", mdp])
    check(rc == 0, f"-dp 2 failed:\n{text_c[-2000:]}")
    if torch.cuda.device_count() == 1:
        check(open(mdp).read() == open(m).read(),
              "-dp 2 on one card did not save the -dp 0 model")
        print("  CLI -dp 2 on one card: the single-device fit, the same "
              "model bytes as -dp 0")
    else:
        check("[data-parallel over" in text_c, "-dp 2 did not run NCCL")
        check(abs(float(metric_line(text_c).split()[-1]) - m_straight)
              <= 0.03, "the NCCL -dp fit is more than 0.03 off")
        print(f"  CLI -dp 2 over NCCL: {metric_line(text_c)}")

    # Random Forests under -dp 2 (gloo on the card)
    rf = RFRanker(n_bags=EXT_BAGS)
    zero_counts()
    G.check_same_models = keep
    import ranklib_tpu_torch.models.rf as RFM
    RFM.check_same_models = keep
    seen.clear()
    rf_held = []
    try:
        with held_ranks(mesh.size, N_LEAVES - 1, tmp, rf_held):
            t1 = time.perf_counter()
            quiet(rf.fit, fit["train"], scorer, device=dev, mesh=mesh)
            wall_rf = time.perf_counter() - t1
    finally:
        G.check_same_models = RFM.check_same_models = check_models
    rf_ranks = rf.rank_launches
    rf_parent = (counts()["histogram"], H.histogram_multi.launches)
    rf1 = RFRanker(n_bags=EXT_BAGS)
    silently(rf1.fit, fit["train"], scorer, device=dev)
    m_rf = score_dataset(scorer, fit["train"], rf.eval_dataset(
        fit["train"], dev), dev)[0]
    m_rf1 = score_dataset(scorer, fit["train"], rf1.eval_dataset(
        fit["train"], dev), dev)[0]
    print(f"  RF -bag {EXT_BAGS} -dp 2 (gloo): {wall_rf:.1f} s; rank "
          f"launches {rf_ranks}; bags equal on both ranks: "
          f"{seen == [1] * EXT_BAGS}; NDCG@10 {m_rf:.4f} vs single-device "
          f"{m_rf1:.4f}")
    check(seen == [1] * EXT_BAGS, "the ranks' bags differ")
    print(f"    each rank's first {N_LEAVES - 1} B1 launches (the first bag) "
          f"held against the plain version: counts exact, sums max_abs_err "
          f"{max(c['max_abs_err'] for calls in rf_held for c in calls):.3e}")
    check(all(r["histogram"] == EXT_BAGS * 99 for r in rf_ranks),
          "a rank's B1 launches are not 4 bags x 99")
    check(rf_parent == (0, 0), "the parent grew trees under -dp")
    check(all(r.get("histogram_multi", 0) == 0 for r in rf_ranks),
          "the -dp forest launched B7")
    check(abs(m_rf - m_rf1) <= 0.03, "the -dp forest is 0.03 off")
    out["rf"] = rf_ranks

    # the library API: the CLI's data, model and metric
    zero_counts()
    ds = api.read(train_path)
    fb_calls = []
    with kept_calls(ens_mod, "forest_eval_frombins", fb_calls):
        model = api.train(ds, ranker=6, metric="NDCG@10", n_trees=EXT_TREES,
                          n_leaves=N_LEAVES, device=dev)
        m_api = api.evaluate(model, ds, metric="NDCG@10", device=dev)
    c = counts()
    check(len(fb_calls) == c["forest_eval_frombins"],
          "a B4 launch of the API was not kept")
    hold_frombins(fb_calls, "api.train/api.evaluate")
    del fb_calls
    print(f"  api.train/api.evaluate: NDCG@10 {m_api:.4f}; launches {c} "
          f"(B4's bit-equal to the plain version)")
    check(metric_line(text).endswith(f"{m_api:.4f}"),
          "the API's metric is not the CLI's")
    check(model.model_str() == open(m).read(),
          "the API's model is not the CLI's")
    check(c["histogram"] == want and c["forest_eval_frombins"] > 0,
          "the API did not run B1 and B4")
    out["api"] = c
    out["launches"] = {
        k: sum(part[k] for part in (out["ckpt"], out["resume"], out["api"]))
        + sum(r[k] for r in ranks + rf_ranks)
        for k in ("histogram", "split_scan", "forest_eval_frombins")}
    out["train_path"] = train_path
    return out


# phase 21: -dp for the other rankers at the training width, as two gloo
# ranks on the one card: Coordinate Ascent -r 2 -i 10, 1 sweep (RankLib's
# -r 5 -i 25 and 25 sweeps cut for the time limit); RankBoost and AdaRank
# -round 50 (of 300 and 500); RankNet, LambdaRank and ListNet 1, 1 and 2
# epochs (of 100, 100 and 1,500), with phase 5's 300 validation queries;
# the nets again on 64 queries (1 epoch at 10x the rates) on the card and
# on two CPU ranks. -sparse -dp on phase 19's 700-wide file at its cut
# (CA -r 1 -i 10, RankBoost 100 and AdaRank 500 rounds).
DP_CA = dict(n_restart=2, n_max_iteration=10, max_passes=1)
DP_ROUNDS, DP_EPOCHS, DP_CPU_QUERIES = 50, (1, 1, 2), 64


def _dp_rank(out_dir, fn, rank, device, group, jobs):
    """A phase-21 rank: ``fn`` (``parallel.dp.run_jobs``) over ``jobs``,
    job by job, with every step (a sweep, a round, an epoch) timed
    (synchronised wall ms) and the first histogram launch on each new id
    matrix (each RankBoost fit's first round) held against the plain
    version on the rank's own card tensors, with the rank's document count
    and π mass Σ|π|; the findings go to ``out_dir/rank<r>.json``."""
    from ranklib_tpu_torch.models import adarank, coorascent, neural
    from ranklib_tpu_torch.models import rankboost as PRB
    from ranklib_tpu_torch.ops import histogram as H

    times, held, seen = [], [], set()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    origs = [(coorascent.CoorAscent, "prepare_fit"),
             (PRB.RankBoost, "_build"), (adarank.AdaRank, "prepare_shard"),
             (neural.RankNet, "prepare_fit")]

    def timing(orig):
        def prepare(self, *a, **k):
            step, *rest = orig(self, *a, **k)

            def timed(*sa, **sk):
                sync()
                t0 = time.perf_counter()
                out = step(*sa, **sk)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
                return out
            return (timed, *rest)
        return prepare

    hist = PRB.histogram

    def holding(binsT, grad, w, B):
        got = hist(binsT, grad, w, B)
        key = (binsT.data_ptr(), tuple(binsT.shape))
        if key not in seen:
            seen.add(key)
            want = H.histogram_plain(binsT, grad, w, B)
            held.append({
                "shape": [*binsT.shape, B], "dtype": str(binsT.dtype),
                "device": str(got.device),
                "counts_equal": bool(torch.equal(got[..., 1], want[..., 1])),
                "sums_close": bool(torch.allclose(got[..., 0], want[..., 0],
                                                  **HIST_TOL)),
                "max_abs_err": float((got - want).abs().max()),
                "docs": float(got[0, :, 1].sum()),
                "mass": float(grad.abs().sum())})
        return got

    saved = [(cls, name, getattr(cls, name)) for cls, name in origs]
    for cls, name, orig in saved:
        setattr(cls, name, timing(orig))
    PRB.histogram = holding
    steps, out = [], []
    try:
        for job in jobs:
            times.clear()
            out += fn(rank, device, group, [job])
            steps.append({"name": job.ranker.NAME, "ms": list(times)})
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)
        PRB.histogram = hist
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"steps": steps, "held": held}, f)
    return out


@contextlib.contextmanager
def dp_ranks(n_ranks: int, tmp: str, found: list):
    """Inside the block every ``-dp`` run's ranks go through
    :func:`_dp_rank`; at its end each rank's findings are appended to
    ``found`` and its held launches checked: on the card, counts exact,
    sums within HIST_TOL of the plain version. The rank function must
    pickle by name, so it is taken from this script imported as a
    module."""
    import functools
    import importlib

    from ranklib_tpu_torch.parallel import dist

    me = importlib.import_module("chip_smoke")
    out_dir = tempfile.mkdtemp(dir=tmp)
    orig = dist.run

    def run(mesh, fn, *args, **kw):
        return orig(mesh, functools.partial(me._dp_rank, out_dir, fn),
                    *args, **kw)

    dist.run = run
    try:
        yield
    finally:
        dist.run = orig
    for r in range(n_ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            found.append(json.load(f))
        held = found[r]["held"]
        check(held and all(c["device"].startswith("cuda") for c in held),
              f"rank {r}'s RankBoost histograms were not held on the card")
        check(all(c["counts_equal"] and c["sums_close"] for c in held),
              f"rank {r}'s histogram differs from the plain version on its "
              f"own ids: {held}")


def _params_err(a, b) -> float:
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for pa, pb in zip(a.params, b.params) for x, y in zip(pa, pb))


def _weaks_check(got, want, what: str, tol: float = 1e-5) -> float:
    """The reference's bound for a boosting ranker's record (RankBoost's
    (fid, θ, α), AdaRank's (fid, α)): all but α equal, α within ``tol``;
    returns the largest α gap."""
    check(len(got) == len(want) > 0
          and [w[:-1] for w in got] == [w[:-1] for w in want],
          f"{what}: the -dp weak sequence is not the single-device one")
    err = max(abs(a[-1] - b[-1]) for a, b in zip(got, want))
    check(err <= tol, f"{what}: alphas off by {err:.2e}")
    return err


def dp_rankers_phase(dev, fit, sparse, tmp, smi) -> dict:
    """Phase 21: ``-dp`` for Coordinate Ascent, RankBoost, AdaRank and the
    three nets on phase 5's training set, as two gloo ranks on the one
    card (a hand-built ``parallel.dist.Mesh``), with the launch counters
    at 0: every dense fit, the nets again on 64 queries, and the COO-route
    fits of phase 19's 700-wide file in ONE spawned mesh
    (``parallel.dp.fit_many``); the 64-query nets once more on two CPU
    ranks; the single-device fits beside them; the CLI's -ranker 4 and
    -ranker 9 with -dp 2. Checks: every rank's model equal (the fit's
    check, seen here); CA's weights within 1e-6 and the boosting rankers'
    weak sequences (α within 1e-5) of the single-device fits; B1 one
    launch a round on each rank and none in the parent, each RankBoost
    fit's first launch held in each rank against the plain version on its
    own ids, the two ranks' documents and π masses adding up to the
    single-device fit's; the nets' card and CPU ranks within 1e-5."""
    from ranklib_tpu_torch import cli
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models import neural as PN
    from ranklib_tpu_torch.models import rankboost as PRB
    from ranklib_tpu_torch.models.adarank import AdaRank
    from ranklib_tpu_torch.models.coorascent import CoorAscent
    from ranklib_tpu_torch.ops.sparse_eval import wants_sparse_eval
    from ranklib_tpu_torch.parallel import dist
    from ranklib_tpu_torch.parallel import dp as PDP
    from ranklib_tpu_torch.parallel.dist import Mesh

    scorer = create_scorer("NDCG@10")
    train, vali = fit["train"], fit["vali"]
    nets = [(PN.RankNet, DP_EPOCHS[0]), (PN.LambdaRank, DP_EPOCHS[1]),
            (PN.ListNet, DP_EPOCHS[2])]

    def dense_fits():
        return ([("CoorAscent", CoorAscent(**DP_CA), train, None),
                 ("RankBoost", PRB.RankBoost(n_rounds=DP_ROUNDS,
                                             n_threshold=RB_TC), train,
                  None),
                 ("AdaRank", AdaRank(n_rounds=DP_ROUNDS), train, None)]
                + [(cls.NAME, cls(n_epoch=e), train, vali)
                   for cls, e in nets])

    small = first_queries(train, DP_CPU_QUERIES)

    def small_fits():
        out = []
        for cls, _ in nets:
            r = cls(n_epoch=1)
            r.learning_rate *= 10
            out.append((cls.NAME + "-64", r, small, None))
        return out

    csr, vcsr = sparse["csr"], sparse["vcsr"]
    sparse_fits = [
        ("CoorAscent-coo", CoorAscent(**RAW_CA), csr, vcsr),
        ("RankBoost-sparse", PRB.RankBoost(n_rounds=RAW_RB_ROUNDS,
                                           n_threshold=RB_TC), csr, vcsr),
        ("AdaRank-coo", AdaRank(n_rounds=ADA_ROUNDS), csr, vcsr)]

    # the single-device fits on the card, their steps timed
    single, single_ms = {}, {}
    t0 = time.perf_counter()
    for name, r, tr, va in dense_fits():
        times = []
        with timed_steps(type(r), times):
            quiet(r.fit, tr, scorer, va, device=dev)
        single[name], single_ms[name] = r, float(np.median(times))
    print(f"  single-device fits on the card in "
          f"{time.perf_counter() - t0:.1f} s: ms a step " + ", ".join(
              f"{k} {v:.1f}" for k, v in single_ms.items()))

    # one spawned mesh: two gloo ranks on the one card
    mesh = Mesh((dev, dev), "gloo")
    seen = []
    check_rankers = PDP.check_same_rankers

    def keep(rankers):
        seen.append(len({r.model_str() for r in rankers}))
        check_rankers(rankers)

    fits = dense_fits() + small_fits() + sparse_fits
    zero_counts()
    found = []
    PDP.check_same_rankers = keep
    try:
        with budget(0), dp_ranks(mesh.size, tmp, found):
            check(wants_sparse_eval(csr), "a budget of 0 should route the "
                                          "CSR to the COO layer")
            t1 = time.perf_counter()
            _, text = quiet(PDP.fit_many, mesh, [
                (r, tr, scorer, va) for _, r, tr, va in fits])
            wall = time.perf_counter() - t1
    finally:
        PDP.check_same_rankers = check_rankers
    parent = counts()
    names = [name for name, *_ in fits]
    dp = {name: r for name, r, *_ in fits}
    print(f"  -dp 2 (gloo, 2 ranks on {torch.cuda.get_device_name(0)}): "
          f"{len(fits)} fits in one spawned mesh, {wall:.1f} s with rank "
          f"start-up; every rank's model equal: {seen == [1] * len(fits)}; "
          f"the parent's B1 {parent['histogram']}")
    check(seen == [1] * len(fits), "the ranks' models differ")
    check(parent["histogram"] == 0, "the parent launched B1 under -dp")
    rb_launches = {name: [c["histogram"] for c in dp[name].rank_launches]
                   for name in ("RankBoost", "RankBoost-sparse")}
    check(rb_launches["RankBoost"] == [DP_ROUNDS] * 2
          and rb_launches["RankBoost-sparse"] == [RAW_RB_ROUNDS] * 2,
          f"a rank's B1 launches are not one a round: {rb_launches}")
    check(all(sum(c.values()) == 0 for name, r in dp.items()
              if not name.startswith("RankBoost") for c in r.rank_launches),
          "a ranker without a kernel launched one")

    # against the single-device fits
    ca_err = float(np.abs(dp["CoorAscent"].weights
                          - single["CoorAscent"].weights).max())
    check(ca_err <= 1e-6, f"CA -dp weights off the single-device fit by "
                          f"{ca_err:.2e}")
    rb_err = _weaks_check(dp["RankBoost"].weaks, single["RankBoost"].weaks,
                          "RankBoost")
    ada_err = _weaks_check(dp["AdaRank"].history, single["AdaRank"].history,
                           "AdaRank")
    coo_ca = float(np.abs(dp["CoorAscent-coo"].weights
                          - sparse["CoorAscent"].weights).max())
    check(coo_ca <= 2e-4, f"CA -sparse -dp off the COO fit by {coo_ca:.2e}")
    coo_rb = _weaks_check(dp["RankBoost-sparse"].weaks, sparse["RankBoost"]
                          .weaks, "RankBoost -sparse")
    coo_ada = _weaks_check(dp["AdaRank-coo"].history,
                           sparse["AdaRank"].history, "AdaRank COO")
    net_gap = {cls.NAME: _params_err(dp[cls.NAME], single[cls.NAME])
               for cls, _ in nets}
    check(all(np.isfinite(W).all() for cls, _ in nets
              for W, _ in dp[cls.NAME].params), "a -dp net is not finite")
    print(f"  CA weights off the single-device fit by {ca_err:.2e} (1e-6); "
          f"RankBoost {len(dp['RankBoost'].weaks)} and AdaRank "
          f"{len(dp['AdaRank'].history)} weak rankers, the single-device "
          f"sequences, alphas within {rb_err:.2e} and {ada_err:.2e}; the "
          f"nets (a minibatch of 2 queries a step) off the sequential fits "
          f"by " + ", ".join(f"{k} {v:.2e}" for k, v in net_gap.items()))
    print(f"  -sparse -dp ({BUDGET_ENV}=0): CA off phase 19's COO fit by "
          f"{coo_ca:.2e} (2e-4); RankBoost and AdaRank the COO fits' "
          f"sequences, alphas within {coo_rb:.2e} and {coo_ada:.2e}")

    # B1 inside the ranks, and alone on rank 0's shard
    held = [f["held"] for f in found]
    check(all(len(h) == 2 for h in held), "a rank did not hold each "
                                          "RankBoost fit's first B1 launch")
    step, state, data, _ = single["RankBoost"].prepare_fit(train, scorer,
                                                          None, dev)
    N = data.binned_T.shape[1]
    pot = PRB.pair_potential(state.scores, data.tb, data.uniq, N)
    mass, docs = float(pot.abs().sum()), sum(h[0]["docs"] for h in held)
    ranks_mass = sum(h[0]["mass"] for h in held)
    b1_err = max(c["max_abs_err"] for h in held for c in h)
    print(f"  each rank's first RankBoost B1 launch held against the plain "
          f"version on its own ids {held[0][0]['shape']} "
          f"{held[0][0]['dtype']} (and the -sparse fit's "
          f"{held[0][1]['shape']}): counts exact, max_abs_err {b1_err:.3e} "
          f"(HIST_TOL); documents {[h[0]['docs'] for h in held]} of {N}; "
          f"pi mass {[round(h[0]['mass'], 6) for h in held]}, together "
          f"{ranks_mass:.6f} vs single device {mass:.6f}")
    check(docs == N, "the ranks' histograms do not count every document "
                     "once")
    check(abs(ranks_mass - mass) <= 1e-5 * mass, "the ranks' pi masses do "
                                                 "not add up")
    from ranklib_tpu_torch.gbdt.boost_dist import _shard_arrays

    grid, binned = PRB.host_bins(train, RB_TC)
    _, rows = _shard_arrays(train, binned, 2, 0)
    binsT = torch.from_numpy(np.ascontiguousarray(rows.T)).to(dev)
    del binned, rows, step, state, data, pot
    ones = torch.ones(binsT.shape[1], dtype=torch.bool, device=dev)
    b1_shard, got = hist_point(binsT, ones, RB_TC + 1)
    # the kernel alone, as phase 16 times RankBoost's launch
    grad = torch.from_numpy(np.random.default_rng(9).integers(
        -8, 9, size=binsT.shape[1]).astype(np.float32)).to(dev)
    fn, args, keep = hist_bare(binsT, grad, ones.to(torch.float32),
                               RB_TC + 1)
    b1_shard["bare_ms"] = bare_ms(fn, args)
    check(torch.equal(keep[0], got), "the bare histogram launches wrote "
                                     "another histogram")
    print(f"  B1 alone on rank 0's shard {list(binsT.shape)} {binsT.dtype}, "
          f"B = {RB_TC + 1}: {b1_shard['ms']:.4f} ms through its wrapper "
          f"({b1_shard['bare_ms']:.4f} bare launches) vs plain "
          f"{b1_shard['plain_ms']:.4f}, index_add_ "
          f"{b1_shard['library_ms']:.4f}, bound {b1_shard['bound_ms']:.4f} "
          f"({b1_shard['bound_by']})  [{smi}]")
    del grad, keep, got, ones
    shard_shape = [*binsT.shape, RB_TC + 1]
    del binsT

    # ms a step on rank 0 beside the single-device fits'
    rank_ms = {}
    for name in names:
        ms = found[0]["steps"][names.index(name)]["ms"]
        rank_ms[name] = float(np.median(ms)) if ms else float("nan")
    ms_step = {name: [rank_ms[name], single_ms[name]] for name in single_ms}
    print("  ms a sweep, round or epoch (rank 0, median) vs single device: "
          + "; ".join(f"{k} {a:.1f} vs {b:.1f}" for k, (a, b)
                      in ms_step.items()) + f"  [{smi}]")

    # the 64-query nets on two CPU ranks
    cpu_fits = small_fits()
    t1 = time.perf_counter()
    quiet(PDP.fit_many, dist.make_mesh(2, torch.device("cpu")),
          [(r, tr, scorer, va) for _, r, tr, va in cpu_fits])
    gaps = {name: _params_err(dp[name], r) for name, r, *_ in cpu_fits}
    print(f"  the 64-query nets' 2-rank fits, card vs two CPU ranks "
          f"({time.perf_counter() - t1:.1f} s): parameters differ by "
          + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items()) + " (1e-5)")
    check(all(v <= 1e-5 for v in gaps.values()),
          "the nets' -dp fits differ card vs CPU")

    # RankNet on the COO route: the reference's line, one device
    sub = csr.subset_queries(range(min(RAW_CPU_QUERIES, len(csr.queries))))
    with budget(0):
        _, text = quiet(PN.RankNet(n_epoch=1).fit, sub, scorer, device=dev,
                        mesh=mesh)
    check("(sparse first layer is single-device; -dp ignored)"
          in text.splitlines(), "RankNet -sparse -dp did not print the "
                                "reference's line")
    print("  RankNet on the COO route under -dp: '(sparse first layer is "
          "single-device; -dp ignored)', one device")

    # the CLI: -dp 2 on one card is the single-device fit
    path = os.path.join(tmp, "p21_train.txt")
    write_dataset(path, first_queries(train, 300))
    models = {}
    for ranker, extra in (("4", ["-r", "2", "-i", "10"]), ("9", [])):
        for n in ("0", "2"):
            m = os.path.join(tmp, f"p21_{ranker}_{n}.txt")
            rc, out = quiet(cli.main, ["-train", path, "-ranker", ranker,
                                       *extra, "-dp", n, "-save", m])
            check(rc == 0, f"-ranker {ranker} -dp {n} failed:\n{out[-2000:]}")
            models[ranker, n] = open(m).read()
            if ranker == "9" and n == "2":
                check("(Linear Regression has no data-parallel path; -dp "
                      "ignored)" in out.splitlines(),
                      "-ranker 9 -dp 2 did not print the reference's line")
    if torch.cuda.device_count() == 1:
        check(models["4", "2"] == models["4", "0"],
              "-ranker 4 -dp 2 on one card is not the -dp 0 model")
    check(models["9", "2"] == models["9", "0"],
          "-ranker 9 -dp 2 is not the -dp 0 model")
    print("  CLI: -ranker 4 -dp 2 on one card saves the -dp 0 model bytes; "
          "-ranker 9 -dp 2 prints the reference's line and saves the same "
          "bytes")
    return {"rb_launches": rb_launches, "wall": wall, "ms_step": ms_step,
            "b1_max_abs_err": b1_err, "b1_shard": b1_shard,
            "shard": shard_shape, "ca_err": ca_err, "rb_err": rb_err,
            "ada_err": ada_err, "coo": [coo_ca, coo_rb, coo_ada],
            "net_cpu_gap": gaps}


def first_queries(ds, n: int):
    """The first ``n`` queries of a dense dataset."""
    from ranklib_tpu_torch.data.dataset import Dataset

    return Dataset(ds.queries[:n], ds.n_features)


# phase 22: -dp with ranks that hold no query, as four gloo ranks on the
# one card: 3 training queries of 97-112 documents (one size class, so
# they go to ranks 0, 1 and 2 and rank 3 holds none) x 16 features under
# LambdaMART -tree 5, Random Forests -bag 2, RankBoost -round 20 and
# RankNet -epoch 1 at -dp 4, and RankBoost at -dp 2 with a 1-query
# validation set; the same fits on CPU ranks beside them. -leaf 4 keeps
# every node large enough that no split is a near tie between two sum
# orders (at 10 leaves, two of five trees flip between the single-device
# and the -dp fit on the CPU). 16 features keep each rank's pickled
# arguments small: a spawned rank reads them from a pipe that holds 64 KB,
# so larger ones start the ranks one after another
DPE_QUERIES, DPE_FEATURES, DPE_TREES, DPE_BAGS = 3, 16, 5, 2
DPE_LEAVES, DPE_ROUNDS = 4, 20


def dp_empty_phase(dev, tmp, smi) -> dict:
    """Phase 22: the fits' own ``mesh`` argument on a hand-built
    ``parallel.dist.Mesh`` of gloo ranks on the card, with the launch
    counters at 0 and each fit's rank models seen. Checks: every rank's
    model equal, and equal to the CPU ranks' fit (the forest's trees:
    structure and thresholds, outputs within TOL; LambdaMART's first tree
    so, and its metric within 1e-3, as phase 6 holds it; RankBoost: the
    weak sequence, α within 1e-5; RankNet: parameters within 1e-5); each
    rank's first B1 launch
    held against the plain version and, on the empty rank, all zeros over
    its 256 pad docs; each rank's first B2 launch held (:func:`hold_scans`);
    B1 and B2 launched on every rank of the tree fits, B1 never on
    RankBoost's empty rank; B1 alone on the empty rank's pad docs
    (:func:`hist_point`)."""
    from ranklib_tpu_torch.gbdt.boost_dist import (
        _shard_queries, build_sharded_data,
    )
    from ranklib_tpu_torch.gbdt.binning import bin_features
    from ranklib_tpu_torch.metrics.base import create_scorer, score_dataset
    from ranklib_tpu_torch.models import gbdt as G
    from ranklib_tpu_torch.models import rf as RFM
    from ranklib_tpu_torch.models.neural import RankNet
    from ranklib_tpu_torch.models.rankboost import RankBoost
    from ranklib_tpu_torch.parallel import dist
    from ranklib_tpu_torch.parallel import dp as PDP

    cpu = torch.device("cpu")
    scorer = create_scorer("NDCG@10")
    train = synth_queries(DPE_QUERIES, DPE_FEATURES, 22, 11, 97, 112)
    vali = synth_queries(1, DPE_FEATURES, 23, 11, 97, 112)
    deal = _shard_queries(train, 4)
    empty = [r for r, lst in enumerate(deal) if not lst]
    full = [r for r, lst in enumerate(deal) if lst]
    check(len(empty) >= 1, "the 4-rank deal leaves no rank empty")
    print(f"  {DPE_QUERIES} training queries ({train.n_docs} documents) "
          f"dealt to 4 ranks: {deal}; ranks {empty} hold none")
    seen = []
    check_models, check_rankers = G.check_same_models, PDP.check_same_rankers

    def keep_models(ensembles):
        seen.append(len({e.to_text() for e in ensembles}))
        check_models(ensembles)

    def keep_rankers(rankers):
        seen.append(len({r.model_str() for r in rankers}))
        check_rankers(rankers)

    def fits():
        return {"LambdaMART": G.LambdaMART(n_trees=DPE_TREES,
                                           n_leaves=DPE_LEAVES,
                                           early_stop=0),
                "RF": RFM.RFRanker(n_bags=DPE_BAGS, n_leaves=DPE_LEAVES),
                "RankBoost": RankBoost(n_rounds=DPE_ROUNDS,
                                       n_threshold=RB_TC),
                "RankNet": RankNet(n_epoch=1),
                "RankBoost-v1": RankBoost(n_rounds=DPE_ROUNDS,
                                          n_threshold=RB_TC)}

    def run_all(rs, mesh4, mesh2, held=None):
        """Every fit of the phase on ``mesh4`` / ``mesh2``; ``held``: the
        tree fits' ranks hold their first B1 and B2 launches; returns each
        part's wall seconds."""
        walls = {}
        for name in ("LambdaMART", "RF"):
            t = time.perf_counter()
            if held is None:
                quiet(rs[name].fit, train, scorer, device=mesh4.devices[0],
                      mesh=mesh4)
            else:
                with held_ranks(4, 1, tmp, held[name][0], held[name][1]):
                    quiet(rs[name].fit, train, scorer,
                          device=mesh4.devices[0], mesh=mesh4)
            walls[name] = time.perf_counter() - t
        t = time.perf_counter()
        quiet(PDP.fit_many, mesh4, [(rs["RankBoost"], train, scorer, None),
                                    (rs["RankNet"], train, scorer, None)])
        walls["RankBoost+RankNet"] = time.perf_counter() - t
        t = time.perf_counter()
        quiet(PDP.fit_many, mesh2, [(rs["RankBoost-v1"], train, scorer,
                                     vali)])
        walls["RankBoost-v1"] = time.perf_counter() - t
        return walls

    card = fits()
    held = {"LambdaMART": ([], []), "RF": ([], [])}
    zero_counts()
    G.check_same_models = RFM.check_same_models = keep_models
    PDP.check_same_rankers = keep_rankers
    try:
        t0 = time.perf_counter()
        walls = run_all(card, dist.Mesh((dev,) * 4, "gloo"),
                        dist.Mesh((dev,) * 2, "gloo"), held)
        wall = time.perf_counter() - t0
    finally:
        G.check_same_models = RFM.check_same_models = check_models
        PDP.check_same_rankers = check_rankers
    parent = counts()
    n_models = 1 + DPE_BAGS + 3
    print(f"  on the card (gloo, 4 and 2 ranks on "
          f"{torch.cuda.get_device_name(0)}): {wall:.1f} s with rank "
          f"start-up (" + ", ".join(f"{k} {v:.1f} s"
                                   for k, v in walls.items())
          + f"); every rank's model equal: {seen == [1] * n_models}; the "
          f"parent's B1 {parent['histogram']}  [{smi}]")
    check(seen == [1] * n_models, "the ranks' models differ")
    check(parent["histogram"] == parent["split_scan"] == 0,
          "the parent grew trees under -dp")

    # the held launches: B1 on an empty rank is all zeros over its pads.
    # The forest's first bag is dealt again: its draws, as the ranks make
    # them
    sampled = card["RF"]._draw_bag(train, DPE_FEATURES, np.random.default_rng(
        card["RF"].seed))[0]
    first_fit = {"LambdaMART": train, "RF": sampled}
    per_tree = DPE_LEAVES - 1
    want = {"LambdaMART": DPE_TREES * per_tree, "RF": DPE_BAGS * per_tree}
    b1_err, scan_err, launches = 0.0, 0.0, {}
    for name in ("LambdaMART", "RF"):
        calls, scans = held[name]
        first = [c[0] for c in calls]
        ds = first_fit[name]
        none = [r for r, lst in enumerate(_shard_queries(ds, 4)) if not lst]
        print(f"  {name}: each rank's first B1 launch held against the plain "
              f"version (counts exact, max_abs_err "
              f"{max(c['max_abs_err'] for c in first):.3e}); documents "
              f"{[c['docs'] for c in first]}; the empty ranks' {none} "
              f"{first[none[0]]['shape']} {first[none[0]]['dtype']}: all "
              f"zeros {[first[r]['zero'] for r in none]}; each rank's first "
              f"B2 launch within the f32 bound of the f64 scan (gain gap "
              f"{max(scans):.3e})")
        check(none and all(first[r]["zero"] and first[r]["docs"] == 0
                           and first[r]["shape"][1] == 256 for r in none),
              f"{name}: an empty rank's root histogram over its 256 pad "
              f"docs is not all zeros")
        check(sum(c["docs"] for c in first) == ds.n_docs,
              f"{name}: the ranks' roots do not count every document once")
        ranks = card[name].rank_launches
        check(all(r["histogram"] == r["split_scan"] == want[name]
                  for r in ranks),
              f"{name}: a rank's B1/B2 launches are not {want[name]}: "
              f"{ranks}")
        launches[name] = ranks
        b1_err = max(b1_err, max(c["max_abs_err"] for c in first))
        scan_err = max(scan_err, max(scans))
    rb = [r["histogram"] for r in card["RankBoost"].rank_launches]
    rb_v = [r["histogram"] for r in card["RankBoost-v1"].rank_launches]
    n_rounds = len(card["RankBoost"].weaks)
    print(f"  RankBoost -dp 4: B1 launches a rank {rb} ({n_rounds} weak "
          f"rankers); -dp 2 with 1 validation query: {rb_v}, "
          f"{len(card['RankBoost-v1'].weaks)} weak rankers kept")
    check(all(rb[r] == 0 for r in empty),
          "B1 launched on RankBoost's empty ranks")
    check(all(rb[r] == rb[full[0]] > 0 for r in full) and all(
        v == rb_v[0] > 0 for v in rb_v),
          "RankBoost's ranks with queries did not launch B1 alike")
    check(all(sum(c.values()) == 0
              for c in card["RankNet"].rank_launches),
          "RankNet launched a kernel")

    # the same fits on CPU ranks
    cpu_fits = fits()
    t1 = time.perf_counter()
    cpu_walls = run_all(cpu_fits, dist.make_mesh(4, cpu),
                        dist.make_mesh(2, cpu))
    print(f"  the same fits on CPU ranks in {time.perf_counter() - t1:.1f} s "
          f"(" + ", ".join(f"{k} {v:.1f} s" for k, v in cpu_walls.items())
          + ")")

    def same_trees(a, b) -> list:
        """Whether each tree of ``a`` is ``b``'s (structure, thresholds;
        outputs within TOL)."""
        return [all(np.array_equal(getattr(ta, f), getattr(tb, f))
                    for f in ("feature", "threshold", "left", "right",
                              "is_leaf"))
                and np.allclose(ta.output, tb.output, **TOL)
                for ta, tb in zip(a.trees, b.trees, strict=True)]

    # as phases 6 and 10: LambdaMART's lambdas differ card vs CPU in their
    # last bits, which may flip a later near-tie, so its first tree must
    # be the CPU's and its metric within 1e-3; the forest's MART residuals
    # leave every tree the CPU's
    lm = same_trees(card["LambdaMART"].ensemble,
                    cpu_fits["LambdaMART"].ensemble)
    m_lm = [score_dataset(scorer, train, r.eval_dataset(train, dev), dev)[0]
            for r in (card["LambdaMART"], cpu_fits["LambdaMART"])]
    rf_same = [ok for a, b in zip(card["RF"].ensembles,
                                  cpu_fits["RF"].ensembles, strict=True)
               for ok in same_trees(a, b)]
    check(lm[0], "LambdaMART: the card's first tree is not the CPU ranks'")
    check(abs(m_lm[0] - m_lm[1]) <= 1e-3,
          "LambdaMART: train NDCG@10 differs card vs CPU ranks")
    check(all(rf_same), "RF: the card's trees are not the CPU ranks'")
    rb_err = max(_weaks_check(card[k].weaks, cpu_fits[k].weaks,
                              f"{k} card vs CPU")
                 for k in ("RankBoost", "RankBoost-v1"))
    net_err = _params_err(card["RankNet"], cpu_fits["RankNet"])
    check(net_err <= 1e-5, f"RankNet differs card vs CPU by {net_err:.2e}")
    print(f"  card vs CPU ranks: LambdaMART {sum(lm)} of {len(lm)} trees "
          f"identical (train NDCG@10 {m_lm[0]:.6f} vs {m_lm[1]:.6f}); RF "
          f"{sum(rf_same)} of {len(rf_same)}; RankBoost's sequences equal, "
          f"alphas within {rb_err:.2e}; RankNet's parameters within "
          f"{net_err:.2e}")

    # B1 alone on the empty rank's shard: 256 pad docs of weight 0
    feats, _, _, thr, binned, _, _ = G.flatten_binned(train, 256)
    if binned is None:
        binned = bin_features(feats, thr)
    shard, _, _ = build_sharded_data(train, binned, 4, empty[0], dev)
    check(not shard.doc_mask.any() and shard.binned_T.shape[1] == 256,
          "the empty rank's shard is not 256 pad docs")
    pads, got = hist_point(shard.binned_T, shard.doc_mask, 256)
    check(not got.any(), "B1 on the empty rank's pads is not all zeros")
    print(f"  B1 alone on the empty rank's shard "
          f"{list(shard.binned_T.shape)} {shard.binned_T.dtype} (weights 0): "
          f"{pads['ms']:.4f} ms vs plain {pads['plain_ms']:.4f}, index_add_ "
          f"{pads['library_ms']:.4f}, bound {pads['bound_ms']:.4f} "
          f"({pads['bound_by']})  [{smi}]")
    return {"launches": launches, "rb": rb, "rb_v1": rb_v,
            "empty_ranks": empty, "b1_held_max_abs_err": b1_err,
            "scan_gain_gap": scan_err, "rb_err": rb_err, "net_err": net_err,
            "pads": pads, "shape": [DPE_FEATURES, 256, 256], "wall": wall,
            "walls": walls, "cpu_walls": cpu_walls}


# phase 23: -dp over two processes that join one group on the card (gloo);
# LambdaMART -leaf 10 with trees for ~10 s at phase 20's -dp 2 round
# (57.7 ms), RankBoost -round 50 on phase 16's grid
J_TREES, J_ROUNDS, J_WORLD = 170, 50, 2
HOSTBIN_ENV = "RANKLIB_TPU_SERVE_HOSTBIN"
CHUNK_ENV = "RANKLIB_TPU_SERVE_CHUNK_MB"
SHARED_GRID_ENV = "RANKLIB_TPU_KCV_SHARED_GRID"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def joined_worker(rank: int, world: int, init: str, data: str, out: str,
                  device: str) -> int:
    """Phase 23's process ``rank`` of ``world``, started by the phase with
    ``--joined-worker``: joins the group (``parallel.dist.join``, gloo on
    ``device``), reads the training file itself and fits LambdaMART and
    RankBoost with ``mesh=make_mesh(world)`` (its first B1 and B2 launches
    held, :func:`holding`); its findings to ``out``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ranklib_tpu_torch.data.letor import read_letor
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.models.rankboost import RankBoost
    from ranklib_tpu_torch.parallel import dist
    from ranklib_tpu_torch.utils.logging import set_event_log

    found = {"rank": rank}
    try:
        t0 = time.perf_counter()
        r, w, device = dist.join(init_method=init, world_size=world,
                                 rank=rank, backend="gloo",
                                 device=torch.device(device))
        found["join"] = [r, w, str(device), torch.distributed.get_backend()]
        found["join_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train = read_letor(data)
        found["read_s"] = time.perf_counter() - t0
        found["docs"] = train.n_docs
        scorer = create_scorer("NDCG@10")
        mesh = dist.make_mesh(world, device)
        found["mesh"] = [mesh.size, mesh.backend, mesh.joined]
        set_event_log(out + ".ev")         # rank 0 alone writes it
        zero_counts()
        lm = LambdaMART(n_trees=J_TREES, n_leaves=N_LEAVES, early_stop=0)
        with holding(1, True, rank) as (held, scans):
            t0 = time.perf_counter()
            quiet(lm.fit, train, scorer, device=device, mesh=mesh)
            sync(device)
            found["lm_s"] = time.perf_counter() - t0
        set_event_log(None)
        found["lm"] = lm.model_str()
        found["lm_launches"] = lm.rank_launches
        found["held"], found["scan_gap"] = held, scans
        found["lm_metric"] = lm.score_metric(train, scorer, device)
        rb = RankBoost(n_rounds=J_ROUNDS, n_threshold=RB_TC)
        t0 = time.perf_counter()
        quiet(rb.fit, train, scorer, device=device, mesh=mesh)
        sync(device)
        found["rb_s"] = time.perf_counter() - t0
        found["rb"] = [list(map(float, x)) for x in rb.weaks]
        found["rb_launches"] = rb.rank_launches
        found["process_counts"] = counts()
        found["modules"] = sorted(m for m in ("jax", "ranklib_tpu")
                                  if m in sys.modules)
    except Exception:
        import traceback

        found["error"] = traceback.format_exc()
    finally:
        with open(out, "w") as f:
            json.dump(found, f)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 1 if "error" in found else 0


def spawned_pair(rank, device, group, lm_args, rb_job):
    """Phase 23's spawned rank: LambdaMART (``models.gbdt._fit_rank`` of
    ``lm_args``) and then RankBoost (its ``ShardJob``) on one group; rank
    0's event log holds LambdaMART's rounds alone. Returns (LambdaMART's
    result, RankBoost's, the two fits' seconds)."""
    from ranklib_tpu_torch.models.gbdt import _fit_rank
    from ranklib_tpu_torch.utils.logging import set_event_log

    t0 = time.perf_counter()
    lm = _fit_rank(rank, device, group, *lm_args)
    sync(device)
    t_lm = time.perf_counter() - t0
    set_event_log(None)
    t0 = time.perf_counter()
    rb = rb_job(rank, device, group)
    sync(device)
    return lm, rb, t_lm, time.perf_counter() - t0


def joined_phase(dev, tmp, smi, train_path, sparse_path, ens, Xh,
                 scores_host) -> dict:
    """Phase 23. (a) Two processes started here (``--joined-worker``)
    join one gloo group on the card through a ``file://`` rendezvous and
    fit LambdaMART and RankBoost with ``-dp 2``: every process's model
    equal, and equal to the spawned two-rank gloo mesh's on the same file;
    B1 and B2 launched in each process, its first ones held against the
    plain versions. (b) The shared-grid ``-sparse -kcv 3`` CLI
    (``RANKLIB_TPU_KCV_SHARED_GRID=1``) on phase 18's 700-feature file,
    ``-ranker 6`` and ``8``. (c) ``eval_matrix`` under
    ``RANKLIB_TPU_SERVE_HOSTBIN=0`` at the serving shape: B3 on uploaded
    features, bit-equal to the host-binned route; and under
    ``RANKLIB_TPU_SERVE_CHUNK_MB``."""
    from ranklib_tpu_torch import cli, evaluator
    from ranklib_tpu_torch.data import binned as PB
    from ranklib_tpu_torch.data.letor import read_letor
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.models.rankboost import RankBoost
    from ranklib_tpu_torch.ops import forest_eval as fe
    from ranklib_tpu_torch.parallel import dist
    from ranklib_tpu_torch.utils.logging import set_event_log

    out = {}
    # (a) the joined processes
    jdir = tempfile.mkdtemp(prefix="joined_", dir=tmp)
    init = "file://" + os.path.join(jdir, "rendezvous")
    root = os.path.dirname(os.path.abspath(__file__))
    files = [os.path.join(jdir, f"rank{r}.json") for r in range(J_WORLD)]
    t0 = time.perf_counter()
    procs = []
    try:
        # each process's output to a file: a full pipe would stall it
        # while its peer waits for it in a collective
        for r in range(J_WORLD):
            with open(files[r] + ".log", "w") as log_f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--joined-worker", str(r), str(J_WORLD), init,
                     train_path, files[r], str(dev)],
                    cwd=root, stdout=log_f, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    logs = [open(f + ".log").read() for f in files]
    found = []
    for r, p in enumerate(procs):
        check(os.path.exists(files[r]),
              f"joined process {r} wrote nothing:\n{logs[r][-3000:]}")
        with open(files[r]) as f:
            found.append(json.load(f))
        check(p.returncode == 0 and "error" not in found[r],
              f"joined process {r} failed:\n"
              f"{found[r].get('error', logs[r][-3000:])}")
    j_ms = round_ms(files[0] + ".ev")
    check(os.path.getsize(files[1] + ".ev") == 0,
          "a joined process other than rank 0 wrote the event log")
    for f in found:
        check(f["join"] == [f["rank"], J_WORLD, str(dev), "gloo"]
              and f["mesh"] == [J_WORLD, "gloo", True],
              f"process {f['rank']} did not join as rank {f['rank']}: "
              f"{f['join']} {f['mesh']}")
        check(f["modules"] == [], f"process {f['rank']} imported "
                                  f"{f['modules']}")
    lm_same = len({f["lm"] for f in found}) == 1
    rb_same = len({json.dumps(f["rb"]) for f in found}) == 1
    check(lm_same and rb_same, "the joined processes' models differ")
    per_tree = N_LEAVES - 1
    for f in found:
        own = f["lm_launches"][f["rank"]]
        check(own["histogram"] == own["split_scan"] == J_TREES * per_tree,
              f"process {f['rank']}: B1/B2 launches {own}, not "
              f"{J_TREES} x {per_tree}")
        check(f["rb_launches"][f["rank"]]["histogram"] == J_ROUNDS,
              f"process {f['rank']}: RankBoost's B1 launches are not "
              f"{J_ROUNDS}")
        check(len(f["held"]) == 1 and f["held"][0]["device"] == str(dev)
              and f["held"][0]["counts_equal"]
              and f["held"][0]["sums_close"],
              f"process {f['rank']}: its first B1 launch differs from the "
              f"plain version: {f['held']}")
        check(len(f["scan_gap"]) == 1,
              f"process {f['rank']} held no B2 launch")
    print(f"  {J_WORLD} joined processes (gloo on {dev}, file:// "
          f"rendezvous): {wall:.1f} s in all; join "
          f"{max(f['join_s'] for f in found):.1f} s, read "
          f"{max(f['read_s'] for f in found):.1f} s "
          f"({found[0]['docs']} docs); LambdaMART -tree {J_TREES} -leaf "
          f"{N_LEAVES} {[round(f['lm_s'], 2) for f in found]} s, "
          f"{j_ms:.3f} ms a round (rank 0's event log), train NDCG@10 "
          f"{found[0]['lm_metric']:.4f} in each: "
          f"{len({f['lm_metric'] for f in found}) == 1}; RankBoost -round "
          f"{J_ROUNDS} {[round(f['rb_s'], 2) for f in found]} s; models "
          f"equal across the processes: LambdaMART {lm_same}, RankBoost "
          f"{rb_same}  [{smi}]")
    print(f"  B1/B2 launches a process (LambdaMART): "
          f"{[f['lm_launches'][f['rank']]['histogram'] for f in found]}/"
          f"{[f['lm_launches'][f['rank']]['split_scan'] for f in found]}; "
          f"RankBoost's B1 "
          f"{[f['rb_launches'][f['rank']]['histogram'] for f in found]}; "
          f"each process's first B1 launch held (counts exact, max_abs_err "
          f"{max(f['held'][0]['max_abs_err'] for f in found):.3e}, root "
          f"documents {[f['held'][0]['docs'] for f in found]}), its first "
          f"B2 within the f32 bound (gain gap "
          f"{max(f['scan_gap'][0] for f in found):.3e})")

    # the spawned two-rank mesh on the same file: both fits in one mesh,
    # so its ranks start once
    import importlib

    from ranklib_tpu_torch.parallel.dp import take_rank0

    me = importlib.import_module("chip_smoke")
    train = read_letor(train_path)
    scorer = create_scorer("NDCG@10")
    mesh = dist.Mesh((dev, dev), "gloo")
    ev = os.path.join(jdir, "spawned.ev")
    zero_counts()
    set_event_log(ev)
    lm = LambdaMART(n_trees=J_TREES, n_leaves=N_LEAVES, early_stop=0)
    rb = RankBoost(n_rounds=J_ROUNDS, n_threshold=RB_TC)
    t0 = time.perf_counter()
    try:
        ranks, _ = quiet(lambda: dist.run(
            mesh, me.spawned_pair,
            lm.rank_args(train, scorer, None, dev, mesh),
            rb.dp_job(mesh, train, scorer)))
    finally:
        set_event_log(None)
    s_wall = time.perf_counter() - t0
    lm.take_ranks([r[0] for r in ranks])
    take_rank0(rb, [r[1] for r in ranks])
    s_lm, s_rb = (max(r[i] for r in ranks) for i in (2, 3))
    s_ms = round_ms(ev)
    spawned_lm = lm.model_str() == found[0]["lm"]
    spawned_rb = [list(map(float, x)) for x in rb.weaks] == found[0]["rb"]
    print(f"  the spawned two-rank gloo mesh on the same file, both fits in "
          f"one mesh: {s_wall:.1f} s with rank start-up; LambdaMART "
          f"{s_lm:.1f} s, {s_ms:.3f} ms a round; RankBoost {s_rb:.1f} s; "
          f"the joined models equal the spawned ones: LambdaMART "
          f"{spawned_lm}, RankBoost {spawned_rb}")
    check(spawned_lm and spawned_rb,
          "the joined models differ from the spawned mesh's")
    spawned_launches = {k: sum(r[k] for r in lm.rank_launches)
                        for k in ("histogram", "split_scan")}
    spawned_launches["histogram"] += sum(r["histogram"]
                                         for r in rb.rank_launches)
    out["joined"] = {
        "wall": wall, "ms_round": j_ms, "ms_round_spawned": s_ms,
        "lm_s": [f["lm_s"] for f in found], "lm_s_spawned": s_lm,
        "rb_s": [f["rb_s"] for f in found], "rb_s_spawned": s_rb,
        "spawned_wall": s_wall,
        "process_launches": [
            {k: f["lm_launches"][f["rank"]][k]
             + (f["rb_launches"][f["rank"]][k] if k == "histogram" else 0)
             for k in ("histogram", "split_scan")} for f in found],
        "spawned_launches": spawned_launches,
        "held_max_abs_err": max(f["held"][0]["max_abs_err"] for f in found),
        "scan_gain_gap": max(f["scan_gap"][0] for f in found)}

    # (b) the shared-grid -kcv on phase 18's file (the per-fold default
    # beside it took 5.1-6.1 s against 5.2-5.3, PR 17: dropped for the
    # phase's time)
    calls = []
    orig = PB.binned_from_csr

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    out["kcv"] = {}
    PB.binned_from_csr = counted
    os.environ[SHARED_GRID_ENV] = "1"
    try:
        for ranker, extra in (
                ("6", ["-tree", str(SP_TREES), "-leaf", str(N_LEAVES)]),
                ("8", ["-bag", str(SP_BAGS)])):
            calls.clear()
            zero_counts()
            t0 = time.perf_counter()
            rc, text = quiet(cli.main, [
                "-train", sparse_path, "-ranker", ranker, *extra,
                "-metric2t", "NDCG@10", "-missingZero", "-sparse", "-kcv",
                "3"])
            sync(dev)
            s = time.perf_counter() - t0
            c = counts()
            check(rc == 0 and "not applicable" not in text,
                  f"-kcv 3 -sparse -ranker {ranker} failed:\n{text[-2000:]}")
            avg = [ln for ln in text.splitlines() if ln.startswith("Avg.")]
            check(len(avg) == 1, f"no Avg. line:\n{text[-2000:]}")
            test_m = float(avg[0].split("|")[2])
            check(0.0 <= test_m <= 1.0, f"-kcv test NDCG {test_m}")
            check(not calls, f"-kcv on the shared grid: {len(calls)} CSR "
                             f"binnings, not 0")
            tree_k = "histogram" if ranker == "6" else "histogram_multi"
            check(c[tree_k] > 0 and c["forest_eval_frombins"] > 0,
                  f"-kcv -ranker {ranker} launched {c}")
            out["kcv"][f"{ranker}-shared"] = {"s": s, "launches": c,
                                              "avg": avg[0]}
            print(f"  -kcv 3 -sparse -ranker {ranker} {' '.join(extra)} "
                  f"(shared grid): {s:.1f} s, {len(calls)} CSR binnings; "
                  f"{avg[0].strip()}; launches {c}")
    finally:
        os.environ.pop(SHARED_GRID_ENV, None)
        PB.binned_from_csr = orig
    check(evaluator.KCV_SHARED_GRID_ENV == SHARED_GRID_ENV,
          "the evaluator reads another switch")

    # (c) the serving switches at the serving shape
    fe.forest_eval_bins.launches = fe.forest_eval_frombins.launches = 0
    os.environ[HOSTBIN_ENV] = "0"
    try:
        off = ens.eval_matrix(Xh, dev)
        sync(dev)
        b3 = fe.forest_eval_bins.launches
        fb = fe.forest_eval_frombins.launches
        off_ms = wall_ms(lambda: ens.eval_matrix(Xh, dev), 5)
    finally:
        os.environ.pop(HOSTBIN_ENV, None)
    check(b3 == 1 and fb == 0, f"HOSTBIN=0 launched B3 {b3} and B4 {fb} "
                               f"times, not once and never")
    check(np.array_equal(off, scores_host), "HOSTBIN=0 scores are not the "
                                            "host-binned route's")
    on_ms = wall_ms(lambda: ens.eval_matrix(Xh, dev), 5)
    chunks = {}
    for mb in ("1", "64"):
        os.environ[CHUNK_ENV] = mb
        try:
            fe.forest_eval_frombins.launches = 0
            got = ens.eval_matrix(Xh, dev)
            n = fe.forest_eval_frombins.launches
            chunks[mb] = (n, wall_ms(lambda: ens.eval_matrix(Xh, dev), 5))
        finally:
            os.environ.pop(CHUNK_ENV, None)
        check(np.array_equal(got, scores_host),
              f"CHUNK_MB={mb} scores are not the default's")
    print(f"  eval_matrix at {N_DOCS} docs x {N_TREES} trees: "
          f"{HOSTBIN_ENV}=0 (B3 on uploaded f32, {b3} launch) {off_ms:.3f} "
          f"ms wall vs the host-binned route {on_ms:.3f} ms, bit-equal; "
          + "; ".join(f"{CHUNK_ENV}={mb}: {n} chunks, {ms:.3f} ms, "
                      f"bit-equal" for mb, (n, ms) in chunks.items())
          + f"  [{smi}]")
    out["serving"] = {"b3_launches": b3, "hostbin_off_ms": off_ms,
                      "hostbin_ms": on_ms, "chunks": chunks}
    return out


def bare_times(root: str) -> int:
    """``--bare-times ROOT``: the fused-lambda (B5) and binning (B8)
    kernels of the ``ranklib_tpu_torch`` found under ROOT, each timed by
    bare launches at this script's shapes — a round's lambdas at the
    training shape on N(0,1) scores (seed 9), the serving documents
    against the serving model's grid — so that an A/B call times an older
    tree's kernels as this one's are timed. A tree without
    ``lambda_round`` launches its per-chunk kernel once a bucket chunk on
    the ranked chunks. Prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.ops import forest_eval as fe
    from ranklib_tpu_torch.ops import lambda_kernel as LK

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    scorer = create_scorer("NDCG@10")
    train = synth_queries(FIT_QUERIES, N_FEATURES, seed=3, w_seed=11)
    os.environ[FUSED_FLAG] = "1"
    try:
        _, _, data, _ = LambdaMART(n_leaves=N_LEAVES).prepare_fit(
            train, scorer, None, dev)
    finally:
        os.environ.pop(FUSED_FLAG, None)
    npad = data.labels_flat.shape[0]
    scores = torch.from_numpy(np.random.default_rng(9).normal(
        size=npad + 1).astype(np.float32)).to(dev)
    lib = LK._kernels()
    if hasattr(LK, "lambda_round"):
        launches = [LK.launch_args(data.fused, scores)]
    else:
        launches = []
        for lab, msk, didx in data.tb:
            vecs = LK.ranked_pair_inputs(scorer, lab, scores[didx], msk)[1]
            out = (torch.empty_like(vecs[0]), torch.empty_like(vecs[0]))
            launches.append(((*(v.data_ptr() for v in vecs),
                              *vecs[0].shape, out[0].data_ptr(),
                              out[1].data_ptr(), stream), (vecs, out)))

    def round_():
        return max([lib.lambda_pairs(*args) for args, _ in launches])

    b5 = bare_ms(round_, ())
    ens = synthetic_ensemble(N_TREES, N_LEAVES, N_FEATURES,
                             np.random.default_rng(0))
    Xd = torch.from_numpy(np.asarray(np.random.default_rng(1).normal(
        size=(N_DOCS, N_FEATURES)), np.float32)).to(dev)
    pack = ens.forest_pack(N_FEATURES, dev)
    ids = torch.empty((N_FEATURES, N_DOCS), dtype=torch.uint8, device=dev)
    b8 = bare_ms(fe._kernels().forest_bins_only_u8,
                 (Xd.data_ptr(), N_DOCS, N_FEATURES, pack.grid.data_ptr(),
                  int(pack.grid.shape[1]), pack.n_grid, ids.data_ptr(),
                  stream))
    check(torch.equal(ids.to(torch.int32),
                      fe.device_bins(Xd, pack.grid, pack.n_grid)),
          "the bare binning launches wrote other ids")
    print(json.dumps({"root": root, "b5_round_ms": b5,
                      "b5_launches_a_round": len(launches), "b8_ms": b8,
                      "card": smi}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--joined-worker"] and len(sys.argv) == 8:
        # phase 23's processes (on the device the phase names)
        return joined_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                             sys.argv[5], sys.argv[6], sys.argv[7])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--bare-times"] and len(sys.argv) == 3:
        return bare_times(sys.argv[2])
    check(len(sys.argv) == 1, "usage: chip_smoke.py [--bare-times ROOT]")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ranklib_tpu_torch import cli
    from ranklib_tpu_torch.models import rf as RF
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.ops import _build
    from ranklib_tpu_torch.ops import forest_eval as fe

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def header(text: str) -> None:
        print(f"{text}  [at {time.perf_counter() - t_start:.1f} s]")
    # the default routes first: the opt-in flags are set only by the phases
    # that drive their routes
    for flag in (FUSED_FLAG, SPLIT_FLAG):
        os.environ.pop(flag, None)

    header("== phase 1: environment and build")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(os.path.basename(lib._name) for lib in libs.values())})")
    for lib in libs.values():
        print(_build.build_log(lib).strip())

    header("== phase 2: kernels vs plain versions, small cases")
    small_case_checks(dev)
    hist_small_checks(dev)
    scan_small_checks(dev)
    group = RF.bag_group_size(2 * RF_LEAVES - 1, N_FEATURES, 256, FIT_NPAD,
                              RF_BAGS, dev)
    hist_multi_small_checks(dev, group)
    full_small_checks(dev)
    bins_only_small_checks(dev)
    lambda_small_checks(dev)
    probe_small_checks(dev)

    header("== phase 3: main path at full width "
          f"({N_TREES} trees x {N_LEAVES} leaves, {N_FEATURES} features, "
          f"{N_DOCS} docs)")
    ens = synthetic_ensemble(N_TREES, N_LEAVES, N_FEATURES,
                             np.random.default_rng(0))
    Xh = np.asarray(np.random.default_rng(1).normal(
        size=(N_DOCS, N_FEATURES)), np.float32)
    Xd = torch.from_numpy(Xh).to(dev)
    pack = ens.forest_pack(N_FEATURES, dev)
    print(f"pack: n_grid={pack.n_grid}, max_depth={pack.max_depth}, "
          f"{pack.splits.shape[0]} split records, at most "
          f"{pack.chunk_splits} a chunk")
    # the CLI's input: 200 queries of 80-160 docs, graded labels 0-4
    rng = np.random.default_rng(2)
    sizes = rng.integers(80, 161, size=200)
    qptr = np.concatenate([[0], np.cumsum(sizes)])
    Xq = rng.normal(size=(int(qptr[-1]), N_FEATURES)).astype(np.float32)
    Xq = np.round(Xq, 4).astype(np.float32)       # exact through %.6g
    labels = rng.integers(0, 5, size=int(qptr[-1]))
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmpdir.name
    model_path = os.path.join(tmp, "model.txt")
    data_path = os.path.join(tmp, "test.txt")
    write_letor(data_path, Xq, labels, qptr)
    ranker = LambdaMART()
    ranker.ensemble = ens
    ranker.save(model_path)

    fe.forest_eval_frombins.launches = 0
    fe.forest_eval_bins.launches = 0
    fe.device_bins_narrow.launches = 0
    scores_host = ens.eval_matrix(Xh, dev)
    route, _ = ens._device_eval_fn(N_FEATURES, dev)
    scores_dev = route(Xd)
    torch.cuda.synchronize()
    after_eval = fe.forest_eval_frombins.launches
    idv = os.path.join(tmp, "idv.txt")
    score_path = os.path.join(tmp, "scores.txt")
    rc_test = cli.main(["-load", model_path, "-test", data_path,
                        "-metric2T", "NDCG@10", "-idv", idv])
    rc_rank = cli.main(["-load", model_path, "-rank", data_path,
                        "-score", score_path])
    torch.cuda.synchronize()
    launches = {"forest_eval_frombins": fe.forest_eval_frombins.launches,
                "forest_eval_bins": fe.forest_eval_bins.launches}
    print(f"CLI -test rc={rc_test}, -rank rc={rc_rank}; launches {launches}")
    check(rc_test == 0 and rc_rank == 0, "CLI flows failed")
    check(all(v > 0 for v in launches.values()),
          "a kernel of the main path was never launched")
    check(launches["forest_eval_frombins"] > after_eval,
          "the CLI flows did not launch the frombins kernel")
    check(fe.device_bins_narrow.launches == 0,
          "the default serving route launched the split route's binning")

    header("== phase 4: full-width checks and times")
    ids = fe.device_bins(Xd, pack.grid, pack.n_grid).to(torch.uint8)
    binsT = ids.contiguous()
    plain_fb = fe.forest_eval_frombins_plain(
        binsT, *pack.matmul_operands(), tree_chunk=pack.tree_chunk)
    plain_b = fe.forest_eval_bins_plain(
        Xd, pack.grid, *pack.matmul_operands(), n_grid=pack.n_grid,
        tree_chunk=pack.tree_chunk)
    fb = fe.forest_eval_frombins(binsT, pack)
    err_fb = max_err(fb, plain_fb, "frombins kernel vs plain (262144 docs)")
    check(torch.equal(fb, plain_fb), "the frombins kernel is not bit-equal "
                                     "to its plain version at full width")
    bins_full = fe.forest_eval_bins(Xd, pack)
    err_b = max_err(bins_full, plain_b, "bins kernel vs plain (262144 docs)")
    check(torch.equal(bins_full, plain_b), "the bins kernel is not "
                                           "bit-equal to its plain version "
                                           "at full width")
    max_err(torch.from_numpy(scores_host), plain_b.cpu(),
            "eval_matrix (host-binned route) vs plain")
    max_err(scores_dev, plain_b, "device-resident route vs plain")
    # the CLI's outputs against the plain version on the same documents
    ref = fe.forest_eval_bins_plain(
        torch.from_numpy(Xq).to(dev), pack.grid, *pack.matmul_operands(),
        n_grid=pack.n_grid, tree_chunk=pack.tree_chunk).cpu().numpy()
    cli_scores = np.loadtxt(score_path, dtype=np.float64, usecols=2)
    check(cli_scores.shape == ref.shape, "score file has the wrong length")
    err_cli = float(np.abs(cli_scores - ref).max())
    print(f"  CLI -score vs plain: max_abs_err={err_cli:.3e} "
          f"(file rounds to 1e-6)")
    check(err_cli <= 1e-5 + 1e-5 * float(np.abs(ref).max()),
          "CLI scores disagree with the plain version")
    with open(idv) as f:
        idv_lines = f.read().splitlines()
    check(len(idv_lines) == 201, "idv file should hold 200 queries + all")
    ndcg = float(idv_lines[-1].split()[-1])
    check(0.0 <= ndcg <= 1.0, f"NDCG@10 {ndcg} out of range")
    print(f"  CLI NDCG@10 over 200 queries: {ndcg:.4f}")

    ms_fb = event_ms(lambda: fe.forest_eval_frombins(binsT, pack), 20)
    plain_ms_fb = event_ms(lambda: fe.forest_eval_frombins_plain(
        binsT, *pack.matmul_operands(), tree_chunk=pack.tree_chunk), 5)
    ms_b = event_ms(lambda: fe.forest_eval_bins(Xd, pack), 20)
    plain_ms_b = event_ms(lambda: fe.forest_eval_bins_plain(
        Xd, pack.grid, *pack.matmul_operands(), n_grid=pack.n_grid,
        tree_chunk=pack.tree_chunk), 5)
    e2e_host = wall_ms(lambda: ens.eval_matrix(Xh, dev), 5)
    e2e_dev = wall_ms(lambda: route(Xd), 10)
    e2e_plain = wall_ms(lambda: fe.forest_eval_bins_plain(
        Xd, pack.grid, *pack.matmul_operands(), n_grid=pack.n_grid,
        tree_chunk=pack.tree_chunk), 5)
    # the host-binned route's parts, whole matrix at once
    from ranklib_tpu_torch.native.loader import native_bin_features_transposed
    grid_np = ens._model_grid_np(N_FEATURES)
    host_ids = native_bin_features_transposed(Xh, grid_np, pack.n_grid,
                                              np.uint8)
    check(host_ids is not None, "native binner unavailable")
    check(torch.equal(torch.from_numpy(host_ids).to(dev), binsT),
          "host and device binning disagree")
    bin_ms = wall_ms(lambda: native_bin_features_transposed(
        Xh, grid_np, pack.n_grid, np.uint8), 5)
    h2d_ms = wall_ms(lambda: torch.from_numpy(host_ids).to(dev), 10)
    h2d_f32_ms = wall_ms(lambda: torch.from_numpy(Xh).to(dev), 5)
    print(f"  host-binned route parts (wall, median): native binning "
          f"{bin_ms:.3f} ms, uint8 upload {h2d_ms:.3f} ms "
          f"({host_ids.nbytes / h2d_ms / 1e6:.2f} GB/s); f32 upload of X "
          f"{h2d_f32_ms:.3f} ms ({Xh.nbytes / h2d_f32_ms / 1e6:.2f} GB/s)")
    print(f"  device time (CUDA events, median): frombins kernel "
          f"{ms_fb:.4f} ms vs plain {plain_ms_fb:.4f} ms; bins kernel "
          f"{ms_b:.4f} ms vs plain {plain_ms_b:.4f} ms")
    print(f"  wall time (median, synchronised): eval_matrix host-binned "
          f"route {e2e_host:.3f} ms; device-resident route {e2e_dev:.3f} "
          f"ms; plain version {e2e_plain:.3f} ms  [{smi}]")
    # bounds: the ids or features, the scores and the split records read
    # once; one compare a node visited and one add a tree (plus the bins
    # kernel's binary search a value)
    walk = walk_ops(ens, Xd)
    bound_fb = bound(nbytes(binsT, plain_fb) + pack_bytes(pack), walk)
    bound_b = bound(nbytes(Xd, pack.grid, plain_b) + pack_bytes(pack),
                    walk + bin_search_ops(Xd, pack))
    print(f"  bounds: frombins {bound_fb[0]:.4f} ms ({bound_fb[1]}), bins "
          f"{bound_b[0]:.4f} ms ({bound_b[1]}); {walk} operations of the "
          f"walk")
    heap_model_times(Xd, smi)

    header("== phase 5: training path at full width "
          f"({FIT_QUERIES} queries x {N_FEATURES} features, LambdaMART "
          f"{FIT_TREES} trees x {N_LEAVES} leaves, NDCG@10)")
    fit = training_phase(dev)

    header("== phase 6: card vs CPU (10 trees, 200 queries)")
    card_vs_cpu(dev)

    header("== phase 7: training CLI")
    training_cli(tmp)

    # before any profiled phase: rounds timed as fit A's were
    header(f"== phase 8: fused lambdas at the training shape "
           f"({FUSED_FLAG}=1)")
    fused = fused_lambda_phase(dev, fit, tmp, smi)

    header("== phase 9: training kernels vs plain at full width, times")
    hists, scans = training_kernel_times(fit)
    print("  one round's parts at full width (wall ms, median):")
    round_breakdown(fit, dev)
    print(f"  per round (wall, median): fit A {fit['ms_a']:.3f} ms, fit B "
          f"{fit['ms_b']:.3f} ms; peak device memory over fit A "
          f"{fit['peak'] / 2**20:.1f} MiB  [{smi}]")

    header(f"== phase 10: Random Forests at the training width ({RF_BAGS} "
          f"bags x {RF_LEAVES} leaves, {FIT_QUERIES} queries x {N_FEATURES} "
          f"features)")
    rf = rf_training_phase(dev, fit["train"], group)
    print(" card vs CPU (4 bags x 8 leaves, 200 queries)")
    rf_card_vs_cpu(dev)
    rf_hists = rf_kernel_times(rf)
    rf_scan_times(rf)
    del rf["binned_T"], rf["grads"], rf["doc_w"], rf["fmask"]
    print(f"  RF fit {rf['wall']:.3f} s, peak {rf['peak'] / 2**30:.2f} GiB  "
          f"[{smi}]")

    header("== phase 11: the f32 forest route at full width "
          f"({N_TREES} trees x {N_LEAVES} leaves, {N_FEATURES} features, "
          f"{N_DOCS} docs)")
    full = full_route_phase(dev, Xh, Xd)

    header("== phase 12: Random Forests and -combine CLI")
    full_launches = rf_cli(tmp)

    header(f"== phase 13: split serving at full width ({SPLIT_FLAG}=1)")
    split = split_serving_phase(
        dev, ens, pack, Xh, Xd, plain_b,
        {"model": model_path, "data": data_path, "ndcg": ndcg}, smi)

    header("== phase 14: the predicate epilogue at full width")
    pred = pred_phase(dev, ens, Xd, smi)

    header("== phase 15: compiler probes")
    probe = probe_phase(dev, smi)

    header(f"== phase 16: linear and boosting rankers at the training width "
          f"({FIT_QUERIES} queries x {N_FEATURES} features, NDCG@10)")
    ca = coorascent_phase(dev, fit["train"], smi)
    rb = rankboost_phase(dev, fit["train"], smi)
    adalin = adarank_linear_phase(dev, fit["train"], smi)
    print(" card vs CPU (200 queries)")
    linear_boosting_card_vs_cpu(dev)
    print(" the CLI")
    linear_boosting_cli(tmp)
    print(f"  walls: Coordinate Ascent {ca['ms_sweep']:.1f} ms a sweep, peak "
          f"{ca['peak'] / 2**20:.1f} MiB; RankBoost {rb['ms_round']:.3f} ms a "
          f"round; AdaRank {adalin['ada_ms_round']:.3f} ms a round; Linear "
          f"Regression fit {adalin['lr_fit_s']:.3f} s, scoring "
          f"{adalin['lr_score_ms']:.3f} ms  [{smi}]")

    header(f"== phase 17: neural rankers at the training width "
           f"({FIT_QUERIES} queries x {N_FEATURES} features, NDCG@10), "
           f"-kcv and -qrel")
    t17 = time.perf_counter()
    nn = neural_phase(dev, fit["train"], fit["vali"], smi)
    print(" card vs CPU (200 queries, 1 epoch)")
    neural_card_vs_cpu(dev)
    print(" the CLI")
    neural_cli(tmp)
    print("  " + "; ".join(
        f"{name} {v['ms_epoch']:.1f} ms an epoch, {v['us_step']:.1f} us and "
        f"{v['kernels_step']:.1f} kernels a query step, "
        f"{100 * v['busy']:.1f}% busy, peak {v['peak'] / 2**20:.1f} MiB"
        for name, v in nn.items()) + f"; phase 17 "
        f"{time.perf_counter() - t17:.1f} s  [{smi}]")

    header(f"== phase 18: -sparse at {SP_FEATURES} features ({SP_QUERIES} "
           f"queries, {SP_DENSITY:.0%} of the features present) and -ana")
    t18 = time.perf_counter()
    sp = sparse_phase(dev, tmp, smi)
    print(f"  -sparse LambdaMART {sp['ms_round']:.3f} ms a round (dense "
          f"{sp['ms_round_dense']:.3f}); launches on the -sparse paths "
          f"{sp['launches']}; phase 18 {time.perf_counter() - t18:.1f} s  "
          f"[{smi}]")

    header(f"== phase 19: -sparse for the raw-value rankers at "
           f"{SP_FEATURES} features (both routes) and at {WIDE_FEATURES}")
    t19 = time.perf_counter()
    raw = raw_default_route(dev, sp["paths"], smi)
    print(f" the COO route ({BUDGET_ENV}=0)")
    coo = raw_coo_route(dev, raw, smi)
    print(f" card vs CPU ({RAW_CPU_QUERIES} queries)")
    raw_card_vs_cpu(dev, raw)
    raw_b1 = raw["b1"]
    # phase 21's -sparse -dp fits are held to phase 19's
    p19 = {"csr": raw["csr"], "vcsr": raw["vcsr"],
           "RankBoost": raw["fits"]["RankBoost"], **{
               k: coo["models"][k] for k in ("CoorAscent", "AdaRank")}}
    del raw
    torch.cuda.empty_cache()
    print(f" the reference's wide shape ({WIDE_FEATURES} features, "
          f"{WIDE_QUERIES} x {WIDE_DOCS} docs)")
    wide = wide_phase(dev, tmp, smi)
    print(f"  CA sweep at {SP_FEATURES} features (-r 1 -i 10): dense "
          f"{coo['ms_sweep']['dense']:.1f} ms, COO "
          f"{coo['ms_sweep']['coo']:.1f} ms; wide runs' host peak "
          f"{wide['peak_above'] / 2**20:.1f} MiB above the process; B1 "
          f"launches on the -sparse RankBoost fits {raw_b1['launches']} + "
          f"{wide['b1']['launches']}; phase 19 "
          f"{time.perf_counter() - t19:.1f} s  [{smi}]")

    header(f"== phase 20: -ckpt, -eventlog, -profile, -resume, -dp and the "
           f"library API at the training width ({FIT_QUERIES} queries x "
           f"{N_FEATURES} features)")
    t20 = time.perf_counter()
    ext = extensions_phase(dev, fit, tmp, smi)
    print(f"  phase 20 {time.perf_counter() - t20:.1f} s  [{smi}]")

    header(f"== phase 21: -dp for Coordinate Ascent, RankBoost, AdaRank and "
           f"the nets at the training width ({FIT_QUERIES} queries x "
           f"{N_FEATURES} features; two gloo ranks on the card), -sparse -dp "
           f"at {SP_FEATURES} features")
    t21 = time.perf_counter()
    dpr = dp_rankers_phase(dev, fit, p19, tmp, smi)
    del p19
    print(f"  phase 21 {time.perf_counter() - t21:.1f} s  [{smi}]")

    header(f"== phase 22: -dp with ranks that hold no query ({DPE_QUERIES} "
           f"training queries x {DPE_FEATURES} features on four gloo ranks "
           f"on the card; RankBoost at -dp 2 with 1 validation query)")
    t22 = time.perf_counter()
    dpe = dp_empty_phase(dev, tmp, smi)
    print(f"  phase 22 {time.perf_counter() - t22:.1f} s  [{smi}]")

    header(f"== phase 23: -dp over {J_WORLD} processes that join one group "
           f"(gloo on the card; {FIT_QUERIES} queries x {N_FEATURES} "
           f"features), the shared-grid -sparse -kcv at {SP_FEATURES} "
           f"features and the serving switches at {N_DOCS} docs")
    t23 = time.perf_counter()
    joined = joined_phase(dev, tmp, smi, ext["train_path"],
                          sp["paths"]["train"], ens, Xh, scores_host)
    print(f"  phase 23 {time.perf_counter() - t23:.1f} s  [{smi}]")
    tmpdir.cleanup()
    print(f"total {time.perf_counter() - t_start:.1f} s")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd,
              library_ms):
        return {"name": name, "route": "cuda",
                "source": f"ranklib_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    def dp_path(name):
        """A kernel's launches on phase 20's -dp fits (each rank's), with
        the round's ms beside the single-device fit's (B1's: also the
        largest error of its launches held inside the ranks)."""
        held = ({"held_max_abs_err": ext["dp"]["b1_max_abs_err"],
                 "shard": ext["dp"]["b1_shard"]}
                if name == "histogram" else {})
        return {**held, "launches": sum(r[name] for r in ext["dp"]["ranks"]),
                "rank_launches": [r[name] for r in ext["dp"]["ranks"]],
                "rf_rank_launches": [r[name] for r in ext["rf"]],
                "shape": ext["dp"]["shape"],
                "ms_round": ext["dp"]["ms_round"],
                "ms_round_single": ext["dp"]["ms_round_single"]}

    def dp_empty_launches(name):
        """A kernel's launches on phase 22's card fits, every rank's."""
        n = sum(r[name] for ranks in dpe["launches"].values()
                for r in ranks)
        return n + (sum(dpe["rb"]) + sum(dpe["rb_v1"])
                    if name == "histogram" else 0)

    def dp_empty_path(name):
        """Phase 22: each rank's launches of the tree fits (and B1's of
        RankBoost's), the empty rank, and what was held there."""
        out = {"launches": dp_empty_launches(name),
               "empty_ranks": dpe["empty_ranks"],
               **{f"{k}_rank_launches": [r[name] for r in ranks]
                  for k, ranks in dpe["launches"].items()}}
        if name == "histogram":
            out.update({
                "rankboost_rank_launches": dpe["rb"],
                "rankboost_v1_rank_launches": dpe["rb_v1"],
                "held_max_abs_err": dpe["b1_held_max_abs_err"],
                "shape": dpe["shape"],
                "empty_rank_pads": {k: dpe["pads"][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}})
        else:
            out["held_gain_gap"] = dpe["scan_gain_gap"]
        return out

    def joined_launches(name):
        """A kernel's launches in phase 23: the joined processes', the
        spawned mesh's ranks' and the -kcv CLI runs'."""
        j = joined["joined"]
        return (sum(p.get(name, 0) for p in j["process_launches"])
                + j["spawned_launches"].get(name, 0)
                + sum(v["launches"][name] for v in joined["kcv"].values()))

    def joined_path(name):
        j = joined["joined"]
        held = ({"held_max_abs_err": j["held_max_abs_err"]}
                if name == "histogram"
                else {"held_gain_gap": j["scan_gain_gap"]})
        return {"launches": joined_launches(name), **held,
                "process_launches": [p[name] for p in j["process_launches"]],
                "spawned_launches": j["spawned_launches"][name],
                "kcv_launches": {k: v["launches"][name]
                                 for k, v in joined["kcv"].items()},
                "ms_round": j["ms_round"],
                "ms_round_spawned": j["ms_round_spawned"]}

    kernels = [
        entry("forest_eval_frombins", "forest_eval.cu",
              "ranklib_tpu/ops/forest_eval.py:524",
              launches["forest_eval_frombins"]
              + sp["launches"]["forest_eval_frombins"]
              + ext["launches"]["forest_eval_frombins"]
              + joined_launches("forest_eval_frombins"), err_fb, ms_fb,
              plain_ms_fb, bound_fb, None),
        dict(entry("forest_eval_bins", "forest_eval.cu",
                   "ranklib_tpu/ops/forest_eval.py:269",
                   launches["forest_eval_bins"]
                   + joined["serving"]["b3_launches"], err_b, ms_b,
                   plain_ms_b, bound_b, None),
             paths={"hostbin_off": {
                 "launches": joined["serving"]["b3_launches"],
                 "wall_ms": joined["serving"]["hostbin_off_ms"],
                 "hostbin_wall_ms": joined["serving"]["hostbin_ms"]}}),
        dict(entry("histogram", "histogram.cu",
                   "ranklib_tpu/ops/histogram.py:185",
                   fit["launches"]["histogram"] + rb["launches"]
                   + sp["launches"]["histogram"] + raw_b1["launches"]
                   + wide["b1"]["launches"] + ext["launches"]["histogram"]
                   + sum(sum(v) for v in dpr["rb_launches"].values())
                   + dp_empty_launches("histogram")
                   + joined_launches("histogram"),
                   hists["root"][1], hists["root"][2], hists["root"][3],
                   hists["root_bound"], hists["root_library"]),
             paths={
                 "lambdamart": {
                     "launches": fit["launches"]["histogram"],
                     "shape": [N_FEATURES, FIT_NPAD, 256],
                     "max_abs_err": hists["root"][1],
                     "ms": hists["root"][2], "plain_ms": hists["root"][3],
                     "bound_ms": hists["root_bound"][0],
                     "library_ms": hists["root_library"]},
                 "rankboost": {
                     "launches": rb["launches"], "shape": rb["shape"],
                     "max_abs_err": rb["err"], "ms": rb["ms"],
                     "plain_ms": rb["plain_ms"], "bound_ms": rb["bound"][0],
                     "library_ms": rb["library_ms"]},
                 "sparse": {k: sp["hist"][k] for k in (
                     "launches", "shape", "max_abs_err", "ms", "plain_ms",
                     "bound_ms", "library_ms")},
                 "rankboost_sparse": raw_b1,
                 "rankboost_sparse_wide": wide["b1"],
                 "dp": dp_path("histogram"),
                 "rankboost_dp": {
                     "launches": sum(dpr["rb_launches"]["RankBoost"]),
                     "rank_launches": dpr["rb_launches"]["RankBoost"],
                     "sparse_rank_launches":
                         dpr["rb_launches"]["RankBoost-sparse"],
                     "shape": dpr["shard"],
                     "held_max_abs_err": dpr["b1_max_abs_err"],
                     **{k: dpr["b1_shard"][k] for k in (
                         "max_abs_err", "ms", "bare_ms", "plain_ms",
                         "bound_ms", "bound_by", "library_ms")},
                     "ms_step_dp_vs_single": dpr["ms_step"]},
                 "dp_empty": dp_empty_path("histogram"),
                 "joined": joined_path("histogram")}),
        dict(entry("split_scan", "split_scan.cu",
                   "ranklib_tpu/ops/split_scan.py:43",
                   fit["launches"]["split_scan"] + sp["launches"]["split_scan"]
                   + ext["launches"]["split_scan"]
                   + dp_empty_launches("split_scan")
                   + joined_launches("split_scan"), scans[2][0],
                   scans[2][1], scans[2][2], scans["bound"], None),
             paths={"lambdamart": {"launches": fit["launches"]["split_scan"]},
                    "dp": dp_path("split_scan"),
                    "dp_empty": dp_empty_path("split_scan"),
                    "joined": joined_path("split_scan")}),
        entry("histogram_multi", "histogram_multi.cu",
              "ranklib_tpu/ops/histogram.py:51",
              rf["launches"]["histogram_multi"]
              + sp["launches"]["histogram_multi"]
              + joined_launches("histogram_multi"), rf_hists["root"][0],
              rf_hists["root"][1], rf_hists["root"][2],
              rf_hists["root_bound"], rf_hists["root_library"]),
        entry("forest_eval_full", "forest_eval.cu",
              "ranklib_tpu/ops/forest_eval.py:53", full_launches,
              full["err"], full["ms"], full["plain_ms"], full["bound"], None),
        entry("lambda_pairs", "lambda_pairs.cu",
              "ranklib_tpu/ops/lambda_kernel.py:47", fused["launches"],
              fused["err"], fused["ms"], fused["plain_ms"], fused["bound"],
              None),
        entry("bins_only", "forest_eval.cu",
              "ranklib_tpu/ops/forest_eval.py:384", split["launches"],
              split["err"], split["ms"], split["plain_ms"], split["bound"],
              split["library_ms"]),
        entry("pred_epilogue", "forest_eval.cu",
              "ranklib_tpu/ops/forest_eval.py:606", pred["launches"],
              pred["err"], pred["ms"], pred["plain_ms"], pred["bound"],
              None),
        entry("probes", "probes.cu", "tools/exp_int8_dot_probe.py:68",
              probe["launches"], probe["err"], probe["ms"], probe["plain_ms"],
              probe["bound"], probe["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
