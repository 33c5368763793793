"""``-dp`` over processes the caller started (``parallel.dist.join``, the
counterpart of ``jax.distributed.initialize()``; the reference's
tools/multihost_smoke.py) on the CPU.

The test starts the processes itself: two that join one group, and three
on a training file of two queries, so that one process holds no query.
They meet through a ``file://`` rendezvous in the test's directory, with
``TIMEOUT_S`` cut to 60. Each process reads the files itself and runs the
fits of :func:`_fits` on ``make_mesh(n)`` of its group, then the CLI with
``-dp 2``; it writes what it found to ``rank<r>.json``. This process runs
the same fits on the spawned mesh of the same size (``make_mesh(n, cpu)``
without a group), and the reference's ``make_mesh(n)`` fits on the same
files (XLA host devices). RankNet starts from the reference's initial
draws, which this process writes to a file for the others. Held:

* every process ends with the same model text, and it is the spawned
  fit's, byte for byte (LambdaMART, Random Forests, Coordinate Ascent,
  RankBoost, AdaRank, RankNet; LambdaMART on the streamed ``-sparse`` bin
  matrix);
* each process's model is the reference's ``make_mesh(n)`` fit's, at
  n = 2 and 3, under tests/test_torch_dp.py's and
  tests/test_torch_dp_rankers.py's rules: LambdaMART's first tree in
  structure and thresholds and its metric within 0.03 (dense and
  ``-sparse``), Random Forests' bags tree for tree, Coordinate Ascent's
  weights within 1e-6, RankBoost's and AdaRank's weak sequences with α
  within 1e-5, RankNet's parameters within 5e-5; RankBoost's weak rankers
  are also the reference's single-device fit's (the multi-host smoke's
  rule);
* the CLI's result lines are the spawned run's; rank 0 alone writes the
  event log; each process writes its own trace, named after its rank;
* ``make_mesh(1)`` in a world of two raises, and a process that raises
  fails its peer within the timeout;
* no process imported JAX or the reference.

This module is also the processes' program (``python
tests/test_torch_dp_joined.py --worker ...``): it imports neither at its
top.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from ranklib_tpu_torch.cli import main as port_main  # noqa: E402
from ranklib_tpu_torch.data.binned import read_letor_binned  # noqa: E402
from ranklib_tpu_torch.data.letor import read_letor  # noqa: E402
from ranklib_tpu_torch.metrics.base import create_scorer  # noqa: E402
from ranklib_tpu_torch.models.adarank import AdaRank  # noqa: E402
from ranklib_tpu_torch.models.coorascent import CoorAscent  # noqa: E402
from ranklib_tpu_torch.models.gbdt import LambdaMART  # noqa: E402
from ranklib_tpu_torch.models.neural import RankNet  # noqa: E402
from ranklib_tpu_torch.models.rankboost import RankBoost  # noqa: E402
from ranklib_tpu_torch.models.rf import RFRanker  # noqa: E402
from ranklib_tpu_torch.parallel import dist  # noqa: E402
from ranklib_tpu_torch.parallel.dp import fit_many  # noqa: E402
from ranklib_tpu_torch.utils.errors import RankLibError  # noqa: E402
from ranklib_tpu_torch.utils.logging import set_silent  # noqa: E402

CPU = torch.device("cpu")
RANKERS = ("LambdaMART", "RF", "CA", "RankBoost", "AdaRank", "RankNet",
           "LambdaMART-sparse")
LM_HP = dict(n_trees=5, n_leaves=4, learning_rate=0.2)
RF_HP = dict(n_bags=3, n_trees=2, n_leaves=3)
SPARSE_HP = dict(n_trees=3, n_leaves=4)
CA_HP = dict(n_restart=2, max_passes=2)
RB_HP = AB_HP = dict(n_rounds=10)
NET_HP = dict(n_epoch=2)
N_FEATURES = 6
TREE_FIELDS = ("feature", "threshold", "left", "right", "is_leaf")
CLI_ARGS = ["-ranker", "6", "-tree", "4", "-leaf", "4", "-metric2t",
            "NDCG@10", "-dp", "2"]
WAIT_S = 240            # a worker group's whole run, far above its need


def _fits(paths: dict, mesh) -> dict:
    """name -> the fitted ranker of every fit on ``mesh`` (spawned or
    joined): the tree rankers one ``run`` each, the other four in one
    ``fit_many``."""
    scorer = create_scorer("NDCG@10")
    train = read_letor(paths["train"])
    vali = read_letor(paths["vali"], n_features=train.n_features)
    out = {"LambdaMART": LambdaMART(**LM_HP), "RF": RFRanker(**RF_HP),
           "LambdaMART-sparse": LambdaMART(**SPARSE_HP)}
    out["LambdaMART"].fit(train, scorer, vali, device=CPU, mesh=mesh)
    out["RF"].fit(train, scorer, device=CPU, mesh=mesh)
    btrain = read_letor_binned(paths["train"], quiet=True)
    bvali = read_letor_binned(paths["vali"], thresholds=btrain.thresholds,
                              n_features=btrain.n_features, quiet=True)
    out["LambdaMART-sparse"].fit(btrain, scorer, bvali, device=CPU,
                                 mesh=mesh)
    others = {"CA": CoorAscent(**CA_HP), "RankBoost": RankBoost(**RB_HP),
              "AdaRank": AdaRank(**AB_HP), "RankNet": RankNet(**NET_HP)}
    fit_many(mesh, [(r, train, scorer, vali) for r in others.values()])
    out.update(others)
    return out


def _draws_init(path: str):
    """An ``_init_params`` of the port's nets that returns the initial
    draws saved at ``path`` (the reference's, written by the test)."""
    with np.load(path) as z:
        draws = [(z[f"W{i}"], z[f"b{i}"]) for i in range(len(z.files) // 2)]

    def init(generator, layer_sizes):
        assert list(layer_sizes) == [draws[0][0].shape[0]] + [
            b.shape[0] for _, b in draws]
        return [(W.copy(), b.copy()) for W, b in draws]

    return init


def _plain(x):
    """Model fields as JSON holds them (arrays and tuples as lists)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
        return x.tolist()
    return x


def _cli_lines(argv) -> list:
    """The CLI's result lines ("... on training data: ...")."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = port_main(argv)
    assert rc == 0, buf.getvalue()[-2000:]
    return [ln for ln in buf.getvalue().splitlines()
            if " on " in ln and " data: " in ln]


def _worker(rank: int, world: int, init: str, paths: dict, out_dir: str,
            case: str) -> None:
    """One joined process: its findings to ``out_dir/rank<r>.json``."""
    os.environ["RANKLIB_TPU_TORCH_DEVICE"] = "cpu"
    dist.TIMEOUT_S = 60
    found = {}
    t0 = time.perf_counter()
    try:
        r, w, device = dist.join(init_method=init, world_size=world,
                                 rank=rank)
        found["join"] = [r, w, str(device), torch.get_num_threads()]
        from ranklib_tpu_torch.models import neural as PN

        PN._init_params = _draws_init(paths["draws"])
        if case == "raise":
            try:
                dist.run(dist.make_mesh(world, device), _raise_on_rank1)
            except RankLibError as e:
                found["error"] = str(e)
            found["seconds"] = time.perf_counter() - t0
            return
        set_silent(True)
        fits = _fits(paths, dist.make_mesh(world, device))
        train = read_letor(paths["train"])
        found["models"] = {k: v.model_str() for k, v in fits.items()}
        found["rank_launches"] = fits["LambdaMART"].rank_launches
        found["metric"] = fits["LambdaMART"].score_metric(
            train, create_scorer("NDCG@10"), device)
        found["fields"] = {k: _plain({f: getattr(v, f)
                                      for f in v.MODEL_FIELDS})
                           for k, v in fits.items()
                           if hasattr(v, "MODEL_FIELDS")}
        try:
            dist.make_mesh(1, device)
        except RankLibError as e:
            found["mesh1"] = str(e)
        if case == "cli":
            set_silent(False)
            found["cli"] = _cli_lines(
                ["-train", paths["train"], "-validate", paths["vali"],
                 *CLI_ARGS, "-eventlog", os.path.join(out_dir, "ev.jsonl"),
                 "-profile", os.path.join(out_dir, "prof")])
        found["modules"] = sorted(m for m in ("jax", "ranklib_tpu")
                                  if m in sys.modules)
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(found, f)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _raise_on_rank1(rank, device, group):
    if rank == 1:
        raise ValueError("boom on rank 1")
    torch.distributed.all_reduce(torch.zeros(1), group=group)   # waits


def _start(world: int, paths: dict, out_dir: str, case: str) -> list:
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "rendezvous")
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        env.pop(k, None)
    procs = []
    for r in range(world):
        # output to a file: a full pipe would stall a process while its
        # peers wait for it in a collective
        with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(r), "--world", str(world), "--init", init, "--paths",
                 json.dumps(paths), "--out", out_dir, "--case", case],
                cwd=REPO, env=env, stdout=log_f, stderr=subprocess.STDOUT))
    return procs


def _finish(procs: list, out_dir: str) -> list:
    try:
        for p in procs:
            p.wait(timeout=WAIT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for r in range(len(procs)):
        with open(os.path.join(out_dir, f"rank{r}.log")) as f:
            logs.append(f.read())
    found = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.json")
        assert os.path.exists(path), f"rank {r} wrote nothing:\n{logs[r]}"
        with open(path) as f:
            found.append(json.load(f))
        found[-1]["rc"] = p.returncode
        found[-1]["log"] = logs[r][-3000:]
    return found


def _write_files(root: str, n_train: int, draws: str) -> dict:
    from tests.fixtures import synth_dataset, write_letor_text

    os.makedirs(root, exist_ok=True)
    paths = {"draws": draws}
    for name, nq, seed in (("train", n_train, 9), ("vali", 8, 10)):
        paths[name] = os.path.join(root, f"{name}.txt")
        write_letor_text(synth_dataset(n_queries=nq, n_features=N_FEATURES,
                                       min_docs=8, max_docs=24, seed=seed,
                                       w_seed=4, signal=3.0), paths[name])
    return paths


def _write_draws(path: str) -> str:
    """The reference's initial draws of RankNet (its seed, its layers on
    the files' features), saved for the processes, which import no JAX."""
    import jax
    from ranklib_tpu.models import neural as RN

    net = RankNet(**NET_HP)
    draws = RN._init_params(jax.random.PRNGKey(int(net.seed)),
                            net._layer_sizes(N_FEATURES))
    np.savez(path, **{f"{k}{i}": np.asarray(a) for i, (W, b) in
                      enumerate(draws) for k, a in (("W", W), ("b", b))})
    return path


def _reference_fits(paths: dict, n: int) -> dict:
    """name -> the reference's fit of :func:`_fits` on its ``make_mesh(n)``
    (XLA host devices), on the same files; "RankBoost-single": its
    single-device RankBoost."""
    from ranklib_tpu.data.binned import read_letor_binned as ref_binned
    from ranklib_tpu.data.letor import read_letor as ref_read
    from ranklib_tpu.metrics.base import create_scorer as ref_scorer
    from ranklib_tpu.models import neural as RN
    from ranklib_tpu.models.adarank import AdaRank as RefAda
    from ranklib_tpu.models.coorascent import CoorAscent as RefCA
    from ranklib_tpu.models.gbdt import LambdaMART as RefLM
    from ranklib_tpu.models.rankboost import RankBoost as RefRB
    from ranklib_tpu.models.rf import RFRanker as RefRF
    from ranklib_tpu.parallel.dist import make_mesh as ref_mesh

    scorer, mesh = ref_scorer("NDCG@10"), ref_mesh(n)
    train = ref_read(paths["train"], quiet=True)
    vali = ref_read(paths["vali"], n_features=train.n_features, quiet=True)
    btrain = ref_binned(paths["train"], quiet=True)
    bvali = ref_binned(paths["vali"], thresholds=btrain.thresholds,
                       n_features=btrain.n_features, quiet=True)
    out = {"LambdaMART": RefLM(**LM_HP), "RF": RefRF(**RF_HP),
           "LambdaMART-sparse": RefLM(**SPARSE_HP), "CA": RefCA(**CA_HP),
           "RankBoost": RefRB(**RB_HP), "AdaRank": RefAda(**AB_HP),
           "RankNet": RN.RankNet(**NET_HP), "RankBoost-single": RefRB(**RB_HP)}
    for name, ref in out.items():
        if name == "LambdaMART-sparse":
            ref.fit(btrain, scorer, bvali, mesh=mesh)
        elif name == "RF":
            ref.fit(train, scorer, mesh=mesh)
        elif name == "RankBoost-single":
            ref.fit(train, scorer, vali)
        else:
            ref.fit(train, scorer, vali, mesh=mesh)
    out["metric"] = {k: out[k].score_metric(train, scorer)
                     for k in ("LambdaMART", "LambdaMART-sparse")}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{n: (the joined processes' findings, the spawned fits, the
    reference's fits, paths)} for n = 2 (32 training queries) and 3 (2
    training queries), the CLI's spawned result lines, and the raising
    group's findings. The joined groups run while this process runs the
    spawned fits and the reference's."""
    from ranklib_tpu.utils.logging import set_silent as ref_silent
    from ranklib_tpu_torch.models import neural as PN

    root = str(tmp_path_factory.mktemp("joined"))
    draws = _write_draws(os.path.join(root, "draws.npz"))
    paths = {2: _write_files(os.path.join(root, "q32"), 32, draws),
             3: _write_files(os.path.join(root, "q2"), 2, draws)}
    started = {2: _start(2, paths[2], os.path.join(root, "w2"), "cli"),
               3: _start(3, paths[3], os.path.join(root, "w3"), "fits"),
               "raise": _start(2, paths[2], os.path.join(root, "wr"),
                               "raise")}
    reference, ref_errors = {}, []

    def reference_fits():
        # in a thread, while the spawned ranks run
        ref_silent(True)
        try:
            reference.update({n: _reference_fits(paths[n], n)
                              for n in (2, 3)})
        except Exception as e:
            ref_errors.append(e)
        finally:
            ref_silent(False)

    ref_thread = threading.Thread(target=reference_fits)
    ref_thread.start()
    try:
        set_silent(True)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
            mp.setattr(PN, "_init_params", _draws_init(draws))
            spawned = {n: _fits(paths[n], dist.make_mesh(n, CPU))
                       for n in (2, 3)}
            set_silent(False)
            cli = _cli_lines(["-train", paths[2]["train"], "-validate",
                              paths[2]["vali"], *CLI_ARGS])
    finally:
        set_silent(False)
        ref_thread.join()
        found = {k: _finish(p, os.path.join(
            root, {2: "w2", 3: "w3", "raise": "wr"}[k]))
            for k, p in started.items()}
    if ref_errors:
        raise ref_errors[0]
    return {"found": found, "spawned": spawned, "reference": reference,
            "paths": paths, "cli": cli, "root": root}


@pytest.mark.parametrize("n", [2, 3])
def test_processes_joined_and_clean(runs, n):
    """Every process joined rank r of n on the CPU, with one thread, ended
    with rc 0, and imported neither JAX nor the reference."""
    found = runs["found"][n]
    for r, f in enumerate(found):
        assert f["rc"] == 0, f["log"]
        assert f["join"] == [r, n, "cpu", 1]
        assert f["modules"] == []


@pytest.mark.parametrize("ranker", RANKERS)
@pytest.mark.parametrize("n", [2, 3])
def test_joined_models_equal_spawned(runs, n, ranker):
    """One model text across the joined processes, the spawned fit's at
    the same n byte for byte."""
    texts = {f["models"][ranker] for f in runs["found"][n]}
    assert texts == {runs["spawned"][n][ranker].model_str()}


def _same_tree(got, want):
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    np.testing.assert_allclose(got.output, want.output, rtol=1e-5,
                               atol=1e-6)


def _same_weaks(got, want, alpha_tol=1e-5):
    """RankBoost's (fid, θ, α) or AdaRank's (fid, α) records: all but α
    equal, α within ``alpha_tol``."""
    assert len(got) == len(want) > 0
    assert [[float(x) for x in w[:-1]] for w in got] == [
        [float(x) for x in w[:-1]] for w in want]
    assert max(abs(a[-1] - b[-1]) for a, b in zip(got, want)) < alpha_tol


@pytest.mark.parametrize("ranker", RANKERS)
@pytest.mark.parametrize("n", [2, 3])
def test_joined_fits_match_reference_mesh(runs, n, ranker):
    """Each joined process's model against the reference's make_mesh(n)
    fit on the same files, to tests/test_torch_dp.py's and
    tests/test_torch_dp_rankers.py's bounds (the module docstring)."""
    from ranklib_tpu_torch.gbdt.ensemble import TreeEnsemble
    from ranklib_tpu_torch.models.rf import parse_ensembles

    ref = runs["reference"][n][ranker]
    train = read_letor(runs["paths"][n]["train"])
    for f in runs["found"][n]:
        text = f["models"][ranker]
        if ranker in ("LambdaMART", "LambdaMART-sparse"):
            _same_tree(TreeEnsemble.from_text(text).trees[0],
                       TreeEnsemble.from_text(ref.ensemble.to_text()).trees[0])
            lm = LambdaMART()
            lm.load_str(text)
            m = lm.score_metric(train, create_scorer("NDCG@10"), CPU)
            assert abs(m - runs["reference"][n]["metric"][ranker]) < 0.03
        elif ranker == "RF":
            got = parse_ensembles(text)
            want = [parse_ensembles(e.to_text())[0] for e in ref.ensembles]
            assert len(got) == len(want) == RF_HP["n_bags"]
            for a, b in zip(got, want):
                assert len(a.trees) == len(b.trees) == RF_HP["n_trees"]
                for ta, tb in zip(a.trees, b.trees):
                    _same_tree(ta, tb)
        else:
            fields = f["fields"][ranker]
            if ranker == "CA":
                np.testing.assert_allclose(fields["weights"], ref.weights,
                                           atol=1e-6)
            elif ranker == "RankBoost":
                _same_weaks(fields["weaks"], ref.weaks)
            elif ranker == "AdaRank":
                _same_weaks(fields["history"], ref.history)
                np.testing.assert_allclose(fields["weights"], ref.weights,
                                           atol=1e-5)
            else:
                assert len(fields["params"]) == len(ref.params)
                for (Wp, bp), (Wr, br) in zip(fields["params"], ref.params):
                    np.testing.assert_allclose(Wp, np.asarray(Wr), atol=5e-5)
                    np.testing.assert_allclose(bp, np.asarray(br), atol=5e-5)


def test_lambdamart_matches_reference_mesh(runs):
    """The joined LambdaMART (two processes): its metric, through
    ``score_metric`` in each process, is the same in both, above 0.8 and
    within 0.03 of the reference's make_mesh(2) fit's."""
    metrics = [f["metric"] for f in runs["found"][2]]
    assert len(set(metrics)) == 1
    m_ref = runs["reference"][2]["metric"]["LambdaMART"]
    assert abs(metrics[0] - m_ref) < 0.03 and metrics[0] > 0.8


@pytest.mark.parametrize("n", [2, 3])
def test_rankboost_weaks_equal_single_device(runs, n):
    """tools/multihost_smoke.py's stage 3: the joined weak-ranker sequence
    is the reference's single-device fit's (features equal, thresholds to
    1e-6, α to 1e-4) in every process."""
    single = runs["reference"][n]["RankBoost-single"]
    for f in runs["found"][n]:
        got = f["fields"]["RankBoost"]["weaks"]
        assert len(got) == len(single.weaks) > 0
        for (fg, tg, ag), (fw, tw, aw) in zip(got, single.weaks):
            assert fg == fw and abs(tg - tw) < 1e-6 and abs(ag - aw) < 1e-4


def test_launch_counts_are_the_fits_own(runs):
    """Each process's launch counts of the LambdaMART fit are that fit's
    (none on the CPU: the plain versions), gathered from every rank."""
    for f in runs["found"][2]:
        assert len(f["rank_launches"]) == 2
        assert all(set(c.values()) == {0} for c in f["rank_launches"])


def test_cli_result_lines_equal_spawned(runs):
    """-dp 2 through the CLI in each joined process prints the spawned
    run's result lines (training, validation)."""
    want = runs["cli"]
    assert len(want) == 2
    for f in runs["found"][2]:
        assert f["cli"] == want


def test_cli_eventlog_rank0_and_one_trace_a_rank(runs):
    """Both processes were given the same -eventlog and -profile: the log
    holds one fit's rounds (rank 0's), and the profile directory one trace
    a rank."""
    out = os.path.join(runs["root"], "w2")
    with open(os.path.join(out, "ev.jsonl")) as f:
        rounds = [json.loads(ln) for ln in f if '"round"' in ln]
    assert [e["round"] for e in rounds] == [1, 2, 3, 4]
    traces = sorted(n.split(".")[0] for n in os.listdir(
        os.path.join(out, "prof")) if n.endswith(".pt.trace.json"))
    assert traces == ["rank0", "rank1"]


@pytest.mark.parametrize("n", [2, 3])
def test_make_mesh_below_the_world_raises(runs, n):
    """make_mesh(1) in a joined world of n names both numbers."""
    for f in runs["found"][n]:
        assert f"-dp 1 in a group of {n} joined processes" in f["mesh1"]


def test_a_raising_process_fails_its_peer(runs):
    """Rank 1 raises in its fit; rank 0, waiting in a collective, fails
    too, within the 60 s timeout, each with a RankLibError."""
    r0, r1 = runs["found"]["raise"]
    assert "rank 1 of the 2-process -dp mesh failed" in r1["error"]
    assert "ValueError: boom on rank 1" in r1["error"]
    assert "rank 0 of the 2-process -dp mesh failed" in r0["error"]
    assert r0["seconds"] < 60 + 30 and r0["rc"] == r1["rc"] == 0


def test_join_refusals(monkeypatch):
    """No card and no explicit CPU: join raises instead of running on the
    CPU, as choose_device does; so do half an explicit rendezvous, a
    missing launcher environment, and NCCL on the CPU."""
    for k in ("RANKLIB_TPU_TORCH_DEVICE", "MASTER_ADDR", "MASTER_PORT",
              "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RankLibError, match="no CUDA device"):
        dist.join("file:///nonexistent", 1, 0)
    with pytest.raises(RankLibError, match="together"):
        dist.join("file:///nonexistent", 2)
    with pytest.raises(RankLibError, match="MASTER_ADDR, MASTER_PORT, "
                                           "WORLD_SIZE, RANK not set"):
        dist.join()
    with pytest.raises(RankLibError, match="NCCL needs a card"):
        dist.join("file:///nonexistent", 1, 0, backend="nccl", device="cpu")
    with pytest.raises(RankLibError, match="rank 2 outside a world of 2"):
        dist.join("file:///nonexistent", 2, 2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_join_reads_the_launcher_environment(tmp_path, monkeypatch):
    """Without arguments, join reads what torchrun sets (here a world of
    one on 127.0.0.1); make_mesh then cuts -dp 4 to the world, joined."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("RANKLIB_TPU_TORCH_DEVICE", "cpu")
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                 ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    threads = torch.get_num_threads()
    try:
        assert dist.join() == (0, 1, CPU)
        mesh = dist.make_mesh(4, CPU)
        assert mesh.joined and mesh.size == 1 and mesh.backend == "gloo"
        assert dist.run(mesh, lambda r, d, g, x: (r, str(d), x), 7) == [
            (0, "cpu", 7)]
    finally:
        torch.distributed.destroy_process_group()
        torch.set_num_threads(threads)
    assert not dist.make_mesh(2, CPU).joined


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--paths", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--case", required=True)
    a = ap.parse_args()
    _worker(a.worker, a.world, a.init, json.loads(a.paths), a.out, a.case)
