"""On-card smoke test of ranklib_tpu_torch's serving path (one NVIDIA GPU).

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs CUDA and exits non-zero at once without it. It imports torch,
numpy and ranklib_tpu_torch only (never JAX or the reference package).
Phases, none of whose failures is caught:

1. environment and build: versions, the card's name and power limit, the
   nvcc build of ``ranklib_tpu_torch/csrc/*.cu`` and its ptxas report;
2. each CUDA kernel against its plain PyTorch version on the card, small
   cases: odd shapes, uint8 and int16 ids, n_grid == 256, documents on
   thresholds, NaN and ±inf features, a one-leaf tree (atol = rtol = 1e-5);
   and against the plain f32 traversal;
3. the main path, at the full width the repo measures — 1,000 trees x 10
   leaves over 136 features scoring 262,144 documents — with every launch
   counter at 0: ``TreeEnsemble.eval_matrix`` (host binning, then the
   frombins kernel), the device-resident route (the bins kernel), and the
   CLI's ``-load -test -idv`` and ``-load -rank -score`` flows on a LETOR
   file of 200 queries; then the counters are read;
4. full-width checks and times: each kernel against its plain version on
   the same device inputs, the CLI's outputs against the plain version,
   and median times of each route.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
are the kernels' JSON record and the ``nvidia-smi`` name/power-limit line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TOL = {"atol": 1e-5, "rtol": 1e-5}
N_TREES, N_LEAVES, N_FEATURES, N_DOCS = 1000, 10, 136, 262144
SOURCE = "ranklib_tpu_torch/csrc/forest_eval.cu"


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
    lib = fe._kernels()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({os.path.basename(lib._name)})")
    print(_build.build_log(lib).strip())

    print("== phase 2: kernels vs plain versions, small cases")
    small_case_checks(dev)

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
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
