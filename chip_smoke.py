"""On-card smoke test of ranklib_tpu_torch's main path (one NVIDIA GPU):
serving and training.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs CUDA and exits non-zero at once without it. It imports torch,
numpy and ranklib_tpu_torch only (never JAX or the reference package).
Phases, none of whose failures is caught:

1. environment and build: versions, the card's name and power limit, the
   nvcc builds of ``ranklib_tpu_torch/csrc/*.cu`` (one per source, all
   started together) and their ptxas reports;
2. each CUDA kernel against its plain PyTorch version on the card, small
   cases. Forest kernels: odd shapes, uint8 and int16 ids, n_grid == 256,
   documents on thresholds, NaN and ±inf features, a one-leaf tree (atol =
   rtol = 1e-5), and the plain f32 traversal. Histogram: odd (N, F, B),
   uint8/int16/int32 ids with some ≥ B, bool masks, f32 multiplicities and
   all-zero weights (counts exact, sums atol 2e-4 / rtol 1e-5, two launches
   bit-identical). Split scan: Cn 1 and 2, B 8/11/256/512, feature masks,
   -mls 0 with empty sides (integer histograms with planted ties exactly
   equal; float histograms to rtol 1e-5);
3. the serving path at the full width the repo measures — 1,000 trees x 10
   leaves over 136 features scoring 262,144 documents — with its launch
   counters at 0: ``TreeEnsemble.eval_matrix`` (host binning, then the
   frombins kernel), the device-resident route (the bins kernel), and the
   CLI's ``-load -test -idv`` and ``-load -rank -score`` flows on a LETOR
   file of 200 queries; then the counters are read;
4. serving checks and times: each forest kernel against its plain version
   on the same device inputs, the CLI's outputs against the plain
   version, and median times of each route;
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
8. training kernels at full width: kernel vs plain device times of the
   histogram (root, and a child with ~10% weights) and the scan
   ([1|2, 136, 256, 2]), the peak device memory, one round's parts timed
   alone and the device-busy share of a profiled round.

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
N_TREES, N_LEAVES, N_FEATURES, N_DOCS = 1000, 10, 136, 262144
SOURCE = "ranklib_tpu_torch/csrc/forest_eval.cu"
# training: bench.py's LambdaMART shape, 50 rounds
FIT_TREES, FIT_QUERIES, FIT_VQUERIES = 50, 1500, 300


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


def small_case_checks(dev) -> None:
    from ranklib_tpu_torch.gbdt.ensemble import Tree, _ensemble_eval
    from ranklib_tpu_torch.ops import forest_eval as fe

    def case(name, n_trees, n_leaves, F, N, seed, grid256=False,
             lone_leaf=False):
        rng = np.random.default_rng(seed)
        ens = synthetic_ensemble(n_trees, n_leaves, F, rng)
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
        walk = _ensemble_eval(Xd, *[torch.from_numpy(a).to(dev)
                                    if isinstance(a, np.ndarray) else a
                                    for a in ens._pack()])
        bins_k = fe.forest_eval_bins(Xd, pack)
        bins_p = fe.forest_eval_bins_plain(
            Xd, pack.grid, *pack.matmul_operands(), n_grid=pack.n_grid,
            tree_chunk=pack.tree_chunk)
        print(f" case {name}: {n_trees} trees x {n_leaves} leaves, F={F}, "
              f"N={N}, n_grid={pack.n_grid}")
        max_err(bins_k, bins_p, "bins kernel vs plain")
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
            max_err(fb_k, walk, f"frombins kernel ({dt}) vs f32 traversal")

    case("A", 50, 10, 20, 300, seed=7)
    case("B-odd", 23, 7, 13, 257, seed=11, lone_leaf=True)
    case("C-grid256", 60, 6, 12, 400, seed=5, grid256=True)
    case("D-one-doc", 7, 3, 5, 1, seed=3)


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
        for B in (8, 11, 256, 512):
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
                        torch.cuda.synchronize()
                        what = f"scan Cn={Cn} B={B} {kind} mls={mls}"
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
            print(f"  scan Cn={Cn} B={B}: int exact, float ok")
    print(f"  split-scan small cases: max_abs_err (float) {worst:.3e}")
    return worst


def synth_queries(n_queries, n_features, seed, w_seed, min_docs=80,
                  max_docs=160, gmax=4, signal=2.5):
    """The repo's synthetic LETOR draws (its test fixtures' linear-signal
    branch, copied because the fixtures import the JAX package): per
    query, N(0,1) features and graded labels 0..gmax by quantiles of a
    planted linear score plus noise."""
    from ranklib_tpu_torch.data.dataset import Dataset, Query

    rng = np.random.default_rng(seed)
    w_true = np.random.default_rng(w_seed).normal(size=n_features)
    w_true /= np.linalg.norm(w_true)
    queries = []
    for qi in range(n_queries):
        n = int(rng.integers(min_docs, max_docs + 1))
        feats = rng.normal(size=(n, n_features)).astype(np.float32)
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
def timed_rounds(times: list):
    """Time each round of every LambdaMART fit inside the block
    (synchronised wall ms per ``step`` call); the fits are otherwise the
    users' ``fit``."""
    from ranklib_tpu_torch.models.gbdt import LambdaMART

    orig = LambdaMART.prepare_fit

    def prepare(self, *args, **kw):
        step, *rest = orig(self, *args, **kw)

        def timed(state, t, data):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = step(state, t, data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return state

        return (timed, *rest)

    LambdaMART.prepare_fit = prepare
    try:
        yield
    finally:
        LambdaMART.prepare_fit = orig


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
    with timed_rounds(times_a):
        quiet(fit_a.fit, train, scorer, device=dev)
    torch.cuda.synchronize()
    launches = {"histogram": H.histogram.launches,
                "split_scan": SS.best_splits.launches}
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

    step, state, data, _ = fit_a.prepare_fit(train, scorer, None, dev)
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
            "data": data, "train": train, "vali": vali}


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


def training_cli(tmp) -> None:
    """-train with -validate -test -idv -save for rankers 6 and 0, then
    -load of each saved model: the same test metric."""
    from ranklib_tpu_torch import cli

    paths = {}
    for name, nq, seed in (("train", 300, 6), ("vali", 60, 7),
                           ("test", 60, 8)):
        paths[name] = os.path.join(tmp, f"{name}.txt")
        write_dataset(paths[name], synth_queries(nq, N_FEATURES, seed, 11))
    for ranker in (6, 0):
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
    fm = data.feat_mask
    scans = {}
    for cn, h in ((1, out["root"][0][None]),
                  (2, torch.stack([out["root"][0], out["child"][0]]))):
        fmc = fm.expand(cn, F)
        got = SS.best_splits(h, 1.0, fmc)
        want = SS.best_splits_plain(h, 1.0, fmc)
        torch.cuda.synchronize()
        fin = torch.isfinite(want[0])
        err = float((got[0][fin] - want[0][fin]).abs().max())
        check(torch.allclose(got[0][fin], want[0][fin], rtol=1e-5, atol=0.0),
              "split-scan gains differ at full width")
        scans[cn] = (err, event_ms(lambda: SS.best_splits(h, 1.0, fmc), 50),
                     event_ms(lambda: SS.best_splits_plain(h, 1.0, fmc), 10))
        print(f"  split scan [{cn}, {F}, {B}, 2]: kernel route "
              f"{scans[cn][1]:.4f} ms vs plain {scans[cn][2]:.4f} ms; "
              f"max_abs_err {err:.3e}")
    return out, scans


def round_breakdown(fit, dev) -> dict:
    """Where a full-width round's time goes: fit B's round, and each of
    its parts run alone from the same functions (synchronised wall ms,
    median), plus the device-busy share of one profiled round."""
    from ranklib_tpu_torch.gbdt.grow import grow_tree, leaf_outputs
    from ranklib_tpu_torch.gbdt.lambdas import lambda_fn
    from ranklib_tpu_torch.metrics.base import create_scorer
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.ops import histogram as H
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
        parts = [fn(lab, scores[didx], msk, scl)[0].reshape(-1)
                 for (lab, msk, didx), scl in zip(data.tb, data.tb_scale)]
        zero = torch.zeros(1, device=dev)
        return torch.cat(parts + [zero])[data.tb_inv]

    lam = lambdas()
    w = lam.abs() + 0.5
    arr = grow_tree(data.binned_T, lam, n_bins=B, n_leaves=N_LEAVES,
                    doc_mask=data.doc_mask, feature_mask=data.feat_mask)
    out = leaf_outputs(arr.node_of_doc, lam, w, M, True, data.doc_mask)
    child = data.doc_mask & (arr.node_of_doc == arr.node_of_doc[0])
    h1 = H.histogram(data.binned_T, lam, data.doc_mask, B)[None]
    h2 = torch.cat([h1, h1])
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
        "  scan [2]": wall_ms(lambda: SS.best_splits(h2, 1.0, fm2), 10),
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

    # device-busy share of one round: kernel time over the round's wall
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, 2, data)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy > 0:
        print(f"  profiled round: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}%), {launches} "
              f"kernels; top device time:")
        top = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)[:8]
        for e in top:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"x{e.count:<5} {e.key[:90]}")
    else:
        print(f"  profiled round: wall {wall:.3f} ms, device time not "
              f"measured (the profiler saw no kernels)")
    return parts


def write_letor(path, X, labels, qptr):
    with open(path, "w") as f:
        for q in range(len(qptr) - 1):
            for i in range(qptr[q], qptr[q + 1]):
                feats = " ".join(f"{j + 1}:{v:.6g}" for j, v in enumerate(X[i]))
                f.write(f"{int(labels[i])} qid:{q + 1} {feats} "
                        f"# doc{q + 1}_{i - qptr[q]}\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ranklib_tpu_torch import cli
    from ranklib_tpu_torch.models.gbdt import LambdaMART
    from ranklib_tpu_torch.ops import _build
    from ranklib_tpu_torch.ops import forest_eval as fe

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    print("== phase 1: environment and build")
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

    print("== phase 2: kernels vs plain versions, small cases")
    small_case_checks(dev)
    hist_small_checks(dev)
    scan_small_checks(dev)

    print("== phase 3: main path at full width "
          f"({N_TREES} trees x {N_LEAVES} leaves, {N_FEATURES} features, "
          f"{N_DOCS} docs)")
    ens = synthetic_ensemble(N_TREES, N_LEAVES, N_FEATURES,
                             np.random.default_rng(0))
    Xh = np.asarray(np.random.default_rng(1).normal(
        size=(N_DOCS, N_FEATURES)), np.float32)
    Xd = torch.from_numpy(Xh).to(dev)
    pack = ens.forest_pack(N_FEATURES, dev)
    print(f"pack: n_grid={pack.n_grid}, max_depth={pack.max_depth}, "
          f"{pack.nodes.shape[0]} node records")
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

    print("== phase 4: full-width checks and times")
    ids = fe.device_bins(Xd, pack.grid, pack.n_grid).to(torch.uint8)
    binsT = ids.contiguous()
    plain_fb = fe.forest_eval_frombins_plain(
        binsT, *pack.matmul_operands(), tree_chunk=pack.tree_chunk)
    plain_b = fe.forest_eval_bins_plain(
        Xd, pack.grid, *pack.matmul_operands(), n_grid=pack.n_grid,
        tree_chunk=pack.tree_chunk)
    err_fb = max_err(fe.forest_eval_frombins(binsT, pack), plain_fb,
                     "frombins kernel vs plain (262144 docs)")
    err_b = max_err(fe.forest_eval_bins(Xd, pack), plain_b,
                    "bins kernel vs plain (262144 docs)")
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

    print("== phase 5: training path at full width "
          f"({FIT_QUERIES} queries x {N_FEATURES} features, LambdaMART "
          f"{FIT_TREES} trees x {N_LEAVES} leaves, NDCG@10)")
    fit = training_phase(dev)

    print("== phase 6: card vs CPU (10 trees, 200 queries)")
    card_vs_cpu(dev)

    print("== phase 7: training CLI")
    training_cli(tmp)

    print("== phase 8: training kernels vs plain at full width, times")
    hists, scans = training_kernel_times(fit)
    print("  one round's parts at full width (wall ms, median):")
    round_breakdown(fit, dev)
    print(f"  per round (wall, median): fit A {fit['ms_a']:.3f} ms, fit B "
          f"{fit['ms_b']:.3f} ms; peak device memory over fit A "
          f"{fit['peak'] / 2**20:.1f} MiB  [{smi}]")
    tmpdir.cleanup()
    print(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "forest_eval_frombins", "route": "cuda", "source": SOURCE,
         "replaces": "ranklib_tpu/ops/forest_eval.py:524",
         "launches": launches["forest_eval_frombins"],
         "max_abs_err": err_fb, "ms": ms_fb, "plain_ms": plain_ms_fb},
        {"name": "forest_eval_bins", "route": "cuda", "source": SOURCE,
         "replaces": "ranklib_tpu/ops/forest_eval.py:269",
         "launches": launches["forest_eval_bins"],
         "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_ms_b},
        {"name": "histogram", "route": "cuda",
         "source": "ranklib_tpu_torch/csrc/histogram.cu",
         "replaces": "ranklib_tpu/ops/histogram.py:185",
         "launches": fit["launches"]["histogram"],
         "max_abs_err": hists["root"][1], "ms": hists["root"][2],
         "plain_ms": hists["root"][3]},
        {"name": "split_scan", "route": "cuda",
         "source": "ranklib_tpu_torch/csrc/split_scan.cu",
         "replaces": "ranklib_tpu/ops/split_scan.py:43",
         "launches": fit["launches"]["split_scan"],
         "max_abs_err": scans[2][0], "ms": scans[2][1],
         "plain_ms": scans[2][2]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
