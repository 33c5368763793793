"""The harness: parts found by name, the generator, the roofline counts,
the plain reference on hand-worked cases, the result line, the launcher
of multi-card cells, and what a run imports."""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ltrbench import gen, run
from ltrbench.layer_metrics.roofline import share
from ltrbench.reference import grid, lambdas, metric, tree
from ltrbench_cells import tiny_cells, toy_cells, write

BENCH = run.load_bench()


def test_every_part_loads_by_name():
    roots = (run.HERE,)
    for c in BENCH["configs"]:
        cfg = run.load_json(roots, "configs", c["name"])
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
        assert hasattr(run.load_driver(roots, cfg["driver"]), "Driver")
    for w in BENCH["workloads"]:
        assert run.load_json(roots, "traffic", w["traffic"])["features"]
        assert run.load_json(roots, "limits", w["name"])
    for m in BENCH["per_layer"]:
        assert callable(run.load_metric(roots, m["name"]).read)


def test_cell_of_new_files_only(tmp_path):
    """A cell whose configuration, traffic and limits are new files in
    another directory runs without an edit to any file there."""
    bench, roots = tiny_cells(tmp_path)
    write(roots[0], "traffic", "wide", {**json.load(open(os.path.join(
        roots[0], "traffic", "tiny.json"))), "features": 9})
    bench["workloads"].append({"name": "lambdamart.wide",
                               "config": "lambdamart", "traffic": "wide",
                               "chips": 1, "why": "tests"})
    write(roots[0], "limits", "lambdamart.wide",
          run.load_json(roots, "limits", "lambdamart.tiny"))
    line = run.run_cell(bench, "lambdamart.wide", 7, 0.2, False,
                        torch.device("cpu"), roots=roots)
    assert line["correct"], line["checks"]


def test_list_lengths_of_mslr30k():
    tr = run.load_json((run.HERE,), "traffic", "mslr30k")
    n = gen.list_lengths(tr["train_queries"], tr["docs_per_query"])
    assert len(n) == 18919 and n.min() >= 1 and n.max() <= 1251
    assert abs(n.mean() - 120) < 2
    assert 2.2e6 < n.sum() < 2.3e6


def test_generator_is_deterministic_and_shaped():
    tr = {"train_queries": 30, "validation_queries": 7, "features": 5,
          "presence": 0.5, "grades": 5, "signal": 2.5,
          "docs_per_query": {"mean": 12, "sigma": 0.63, "min": 1,
                             "max": 40}}
    a, av = gen.generate(tr, 2 ** 31 + 5, torch.device("cpu"))
    b, bv = gen.generate(tr, 2 ** 31 + 5, torch.device("cpu"))
    c, _ = gen.generate(tr, 2 ** 31 + 6, torch.device("cpu"))
    for x, y in ((a, b), (av, bv)):
        assert np.array_equal(x.feats, y.feats)
        assert np.array_equal(x.labels, y.labels)
        assert np.array_equal(x.qptr, y.qptr)
    assert not np.array_equal(a.feats, c.feats)
    # the seed reorders one multiset of lengths
    assert sorted(np.diff(a.qptr)) == sorted(np.diff(c.qptr))
    assert a.feats.shape == (a.n_docs, 5) and a.n_queries == 30
    assert 0.3 < (a.feats != 0).mean() < 0.7
    for q in range(a.n_queries):
        lab = a.labels[a.qptr[q]:a.qptr[q + 1]]
        n = len(lab)
        want = np.floor(np.arange(n) * 5 / n)
        assert np.array_equal(np.sort(lab), want)


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernels(self, span):
        return [("k", self.seconds)]


class _Obs:
    def __init__(self, calls, seconds):
        self.calls = calls
        self.trace = _Trace(seconds)
        self.peak = {"bytes_per_s": 1e12, "f32_ops_per_s": 1e13}


def test_histogram_roofline_count():
    m = run.load_metric((run.HERE,), "histogram_roofline")
    ids = torch.zeros((3, 10), dtype=torch.uint8)
    mask = torch.tensor([1, 0, 1, 0, 1, 0, 1, 0, 0, 0], dtype=torch.bool)
    c = m.count((ids, torch.zeros(10), mask, 8), {})
    c = {k: float(v) for k, v in c.items()}
    # 4 docs x 3 features x 1 byte, (grad, weight) f32 per doc, [3, 8, 2]
    # f32 out; 2 adds a doc and feature, one multiply a doc
    assert m.work(c) == (4 * 3 + 4 * 8 + 3 * 8 * 8, 4 * 7)
    obs = _Obs([c], 1e-9)
    assert share(obs, "histogram", m.work) == pytest.approx(
        100 * max(236 / 1e12, 28 / 1e13) / 1e-9)


def test_histogram_multi_roofline_count():
    m = run.load_metric((run.HERE,), "histogram_multi_roofline")
    ids = torch.zeros((4, 6), dtype=torch.int16)
    w = torch.tensor([[1, 0, 2, 0, 0, 0], [0, 0, 1, 1, 0, 0]],
                     dtype=torch.float32)
    c = {k: float(v) for k, v in m.count(
        (ids, torch.zeros(2, 6), w, 16), {}).items()}
    # docs 0, 2, 3 held by some bag: their ids once (2 bytes each); 4
    # (bag, doc) pairs; [2, 4, 16, 2] f32 out
    assert m.work(c) == (3 * 4 * 2 + 4 * 8 + 2 * 4 * 16 * 8, 4 * 9)


def test_split_scan_roofline_count():
    m = run.load_metric((run.HERE,), "split_scan_roofline")
    h = torch.zeros((2, 5, 8, 2))
    c = m.count(((h, h), 1.0, torch.ones((4, 5), dtype=torch.bool)), {})
    assert m.work(c) == (4 * 5 * 8 * 8 + 4 * 5 + 4 * 13, 4 * 5 * 8 * 9)
    c = m.count((h, 1.0), {})
    assert m.work(c) == (2 * 5 * 8 * 8 + 2 * 13, 2 * 5 * 8 * 9)


def test_reference_lambdas_by_hand():
    """One list, labels (2, 0, 1), all scores 0: ranks follow the
    document order, rho = 1/2."""
    lab = torch.tensor([2.0, 0.0, 1.0])
    lam, w = lambdas.ndcg_lambdas(lab, torch.zeros(3), torch.tensor([0, 3]),
                                  10)
    d = [1.0, 1 / math.log2(3), 0.5]            # discounts of ranks 0-2
    idcg = 3 * d[0] + 1 * d[1]
    p01 = 3 * (d[0] - d[1]) / idcg
    p02 = 2 * (d[0] - d[2]) / idcg
    p21 = 1 * (d[1] - d[2]) / idcg
    assert lam.tolist() == pytest.approx(
        [0.5 * (p01 + p02), -0.5 * (p01 + p21), 0.5 * (p21 - p02)])
    assert w.tolist() == pytest.approx(
        [0.25 * (p01 + p02), 0.25 * (p01 + p21), 0.25 * (p02 + p21)])


def test_reference_ndcg_by_hand():
    lab = torch.tensor([2.0, 0.0, 1.0, 0.0, 0.0])
    sc = torch.tensor([0.1, 0.3, 0.2, 5.0, 5.0])
    qptr = torch.tensor([0, 3, 5])
    dcg = 1 / math.log2(3) + 3 / math.log2(4)
    idcg = 3 + 1 / math.log2(3)
    # the second list has no relevant document: 0
    assert metric.mean_ndcg(lab, sc, qptr, 10) == pytest.approx(
        dcg / idcg / 2)


def test_reference_grid_by_hand():
    x = torch.tensor([[0.0, 1.0], [1.0, 2.0], [1.0, 3.0], [2.0, 9.0]])
    thr = grid.thresholds(x, 3)
    assert thr[0].tolist() == [0.0, 1.0, 2.0]
    assert thr[1].tolist() == [1.0, 5.0, 9.0]
    assert grid.bins(x, thr).tolist() == [[0, 0], [1, 1], [1, 1], [2, 2]]
    assert grid.bin_of(thr[1], 5.0) == (1, True)
    assert grid.bin_of(thr[1], 4.0) == (0, False)


def _stump(threshold):
    return tree.Tree(np.array([0, 0, 0]), np.array([threshold, 0, 0],
                                                   np.float32),
                     np.array([1, -1, -1]), np.array([2, -1, -1]),
                     np.array([False, True, True]), np.zeros(3, np.float32))


def test_reference_split_judge_by_hand():
    """Values 1-4 with responses (1, 1, -1, -1): the split at 2 takes the
    whole reduction (gain 4); the one at 3 misses 2/3 of it."""
    x = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    g = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=torch.float64)
    c = torch.ones(4, dtype=torch.float64)
    thr = grid.thresholds(x, 256)
    b = grid.bins(x, thr)
    allf = torch.ones(1, dtype=torch.bool)
    for t_at, gap in ((2.0, 0.0), (3.0, 2 / 3)):
        t = _stump(t_at)
        slot = tree.route(x, t)
        h, st = tree.slot_sums(b, slot, t, g, c, 4, torch.float64)
        got = tree.judge(t, h, st, thr, allf, 1.0, 2)
        assert got == {"split_gap": pytest.approx(gap), "grid_miss": 0}
    t = _stump(2.5)
    slot = tree.route(x, t)
    h, st = tree.slot_sums(b, slot, t, g, c, 4, torch.float64)
    assert tree.judge(t, h, st, thr, allf, 1.0, 2)["grid_miss"] == 1
    grown, slot = tree.grow(b, thr, g, c, allf, 2, 1.0, 4, torch.float64)
    assert grown.threshold[0] == 2.0 and slot.tolist() == [1, 1, 2, 2]


def test_non_finite_readings_fail():
    """A NaN or infinite output reads infinitely far off, and the folds
    over trees and rounds keep it."""
    from ltrbench.reference import judge

    nan = float("nan")
    assert tree.worst(0.0, nan) == math.inf
    assert tree.worst(nan, 0.5) == math.inf
    assert tree.worst(0.25, 0.5) == 0.5
    one = torch.ones(3, dtype=torch.float64)
    assert judge._rel(torch.tensor([1.0, nan, 1.0], dtype=torch.float64),
                      one) == math.inf
    assert judge._rel(one, torch.tensor([1.0, 1.0, math.inf],
                                        dtype=torch.float64)) == math.inf
    assert judge._worst({"leaf_err": 0.0}, {"leaf_err": nan}) == {
        "leaf_err": math.inf}
    x = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    thr = grid.thresholds(x, 256)
    t = _stump(2.0)
    slot = tree.route(x, t)
    g = torch.tensor([1.0, nan, -1.0, -1.0], dtype=torch.float64)
    h, st = tree.slot_sums(grid.bins(x, thr), slot, t, g,
                           torch.ones(4, dtype=torch.float64), 4,
                           torch.float64)
    got = tree.judge(t, h, st, thr, torch.ones(1, dtype=torch.bool), 1.0, 2)
    assert got["split_gap"] == math.inf


def test_forest_sample_covers_every_group_step():
    d = run.load_driver((run.HERE,), "forest_fits")
    groups = [106, 106, 88]
    pairs = d.sample(groups, 4, 2 ** 31 + 3)
    assert pairs == d.sample(groups, 4, 2 ** 31 + 3)
    assert len(pairs) == 12
    for f in range(4):
        bags = [b for g, b in pairs if g == f]
        assert 0 <= bags[0] < 106 <= bags[1] < 212 <= bags[2] < 300


def test_idle_share_of_the_window():
    """Busy time a call from the trace, set against the untraced window:
    0.5 s busy over 2 traced calls, 10 calls in 5 s → 50% idle."""
    m = run.load_metric((run.HERE,), "device.idle_pct")
    obs = run.Observations()
    assert m.read(obs) is None

    class T:
        busy_s, window_s = 0.5, 3.0

    obs.trace, obs.traced_calls = T(), 2
    obs.window_calls, obs.window_s = 10, 5.0
    assert m.read(obs) == pytest.approx(50.0)


def test_result_line_keys(tmp_path):
    bench, roots = tiny_cells(tmp_path)
    for trace in (False, True):
        line = run.run_cell(bench, "lambdamart.tiny", 2 ** 31 + 11, 0.2,
                            trace, torch.device("cpu"), roots=roots)
        want = ["correct", "attempted", "failed", "metrics", "device"]
        want += ["breakdown"] if trace else []
        assert list(line) == want + ["build_s", "checks"]
        # a one-card line: no by_rank, and the count is computed
        assert list(line["device"]) == [
            "platform", "kind", "count", "memory_peak_bytes"] + (
            ["busy_s", "window_s"] if trace else [])
        assert line["device"]["count"] == 1
        for v in line["checks"].values():
            assert set(v) == {"value", "limit"}
        json.dumps(line)


def _execute(bench, roots, trace=0, seconds=0.5, seed=2 ** 31 + 17):
    """``ltrbench.run``'s run of the cell ``toy.cards`` on the CPU: (exit
    code, seconds it took)."""
    args = argparse.Namespace(workload="toy.cards", seed=seed,
                              seconds=seconds, trace=trace)
    t0 = time.perf_counter()
    rc = run.execute(bench, args, roots=roots, platform="cpu")
    return rc, time.perf_counter() - t0


@pytest.mark.parametrize("trace", [0, 1])
def test_two_card_cell_prints_one_line(tmp_path, capfd, trace):
    """A two-"card" cell on the CPU: two workers that join one gloo group
    from the launcher's environment and all-reduce in their windows; one
    line, rank 0's judge, one card counted, one entry a rank."""
    bench, roots = toy_cells(tmp_path, 2)
    rc, _ = _execute(bench, roots, trace)
    out, err = capfd.readouterr()
    assert rc == 0, err
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert {k: v["value"] for k, v in line["checks"].items()} == {
        "judged_on": 0, "outputs_of": 0, "env_gap": 0, "sum_gap": 0}
    assert line["attempted"] > 0
    dev = line["device"]
    assert dev["count"] == 1 and dev["platform"] == "cpu"
    assert [r["rank"] for r in dev["by_rank"]] == [0, 1]
    if trace:
        assert list(line["metrics"]) == []
        assert {"busy_s", "window_s"} <= set(dev)
        assert all({"busy_s", "window_s"} <= set(r)
                   for r in dev["by_rank"])
    else:
        assert list(line["metrics"]) == ["setup_s", "train_rate"]
    assert "check judged_on 0.0 limit 0" in err


@pytest.mark.parametrize("fault_rank, correct", [(0, False), (1, True)])
def test_correct_is_rank_zeros_judge(tmp_path, capfd, fault_rank, correct):
    """A wrong output on rank 0 fails the run; on rank 1 it is never
    judged: the judge reads rank 0's outputs alone."""
    bench, roots = toy_cells(tmp_path, 2, "wrong", fault_rank)
    rc, _ = _execute(bench, roots)
    out, err = capfd.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is correct
    assert line["failed"] == (0 if correct else 1)


@pytest.mark.parametrize("fault", ["raise_setup", "raise_window"])
def test_a_worker_that_raises_fails_the_run(tmp_path, capfd, fault):
    """Rank 1 raises; rank 0, left waiting at the barrier or in its
    all-reduce, is ended: non-zero, no line, rank 1's traceback."""
    bench, roots = toy_cells(tmp_path, 2, fault)
    rc, took = _execute(bench, roots)
    out, err = capfd.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "rank 1 failed" in err and "toy fault in rank 1" in err
    assert took < 60


def test_a_stalled_worker_fails_at_the_bound(tmp_path, capfd, monkeypatch):
    monkeypatch.setattr(run, "SETUP_WAIT_S", 8.0)
    bench, roots = toy_cells(tmp_path, 2, "stall")
    rc, took = _execute(bench, roots)
    out, err = capfd.readouterr()
    assert rc != 0 and out.strip() == ""
    assert "rank 1 did not reach 'set up' within" in err
    assert 8.0 <= took < 40


def test_merge_counts_each_card_once_where_memory_was_allocated():
    """The launcher's line: a card counts once, however many workers
    allocated on it, and not at all where none did; the peak is the
    fullest card's."""
    def worker_line(cards, peak, index):
        return {"metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
                "device": {"platform": "gpu", "kind": "card", "count": 1,
                           "memory_peak_bytes": peak, "cards": cards,
                           "index": index}}

    line = run._merge([worker_line({"A": 5}, 5, 0),
                       worker_line({"A": 7, "B": 3}, 7, 1),
                       worker_line({}, 0, 2)], 12.5)
    dev = line["device"]
    assert list(dev) == ["platform", "kind", "count", "memory_peak_bytes",
                         "by_rank"]
    assert dev["count"] == 2 and dev["memory_peak_bytes"] == 7
    assert dev["by_rank"] == [
        {"rank": 0, "index": 0, "memory_peak_bytes": 5},
        {"rank": 1, "index": 1, "memory_peak_bytes": 7},
        {"rank": 2, "index": 2, "memory_peak_bytes": 0}]
    assert line["metrics"]["setup_s"]["value"] == 12.5


def test_a_worker_that_loads_jax_fails_the_run(tmp_path, capfd):
    bench, roots = toy_cells(tmp_path, 2, "forbidden")
    rc, _ = _execute(bench, roots)
    out, err = capfd.readouterr()
    assert rc == 3 and out.strip() == ""
    assert "rank 1 loaded forbidden modules: jax" in err


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "ltrbench.run",
                          "--workload", "lambdamart.mslr30k", "--seed",
                          "1", "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] "
                          "for m in sys.modules})))"],
                         cwd=run.ROOT, capture_output=True, text=True,
                         timeout=300,
                         env={**os.environ, "RANKLIB_TPU_TORCH_DEVICE":
                              "cpu"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax(tmp_path):
    """A whole run (set-up, window, traced span, judge) loads no module
    whose top-level name is jax, jaxlib, flax or ranklib_tpu."""
    code = f"""
import sys, pathlib, torch
sys.path[:0] = [{run.ROOT!r}, {os.path.dirname(__file__)!r}]
from ltrbench import run, calibrate
from ltrbench_cells import tiny_cells
bench, roots = tiny_cells(pathlib.Path({str(tmp_path)!r}))
for cell in ("lambdamart.tiny", "rf.tiny"):
    run.run_cell(bench, cell, 3, 0.1, True, torch.device("cpu"),
                 roots=roots)
assert not run.forbidden_modules(), run.forbidden_modules()
"""
    names = _top_names(code)
    assert "ranklib_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "ranklib_tpu"}


def test_reference_imports_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {run.ROOT!r})
from ltrbench import gen
from ltrbench.reference import fit, grid, judge, lambdas, metric, sampling, tree
"""
    names = _top_names(code)
    assert not names & {"jax", "jaxlib", "flax", "ranklib_tpu",
                        "ranklib_tpu_torch"}


@pytest.mark.card
def test_tiny_cells_on_the_card(card, tmp_path):
    """Both tiny cells on the card, traced: correct, with the per-layer
    readings of a device trace."""
    bench, roots = tiny_cells(tmp_path)
    for cell in ("lambdamart.tiny", "rf.tiny"):
        line = run.run_cell(bench, cell, 2 ** 31 + 21, 1.0, True, card,
                            roots=roots)
        assert line["correct"], line["checks"]
        assert line["device"]["busy_s"] > 0
        assert line["breakdown"]["device_ops"]


@pytest.mark.card
def test_launcher_over_every_card(card, tmp_path):
    """The launcher over every card of the machine, under NCCL: one
    worker a card, every card counted."""
    n = torch.cuda.device_count()
    bench, roots = toy_cells(tmp_path, n)
    line = run.launch(bench, "toy.cards", 2 ** 31 + 23, 2.0, True, n,
                      "cuda", roots)
    print(json.dumps({k: line[k] for k in ("correct", "attempted",
                                           "device", "checks")}))
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == n
    assert [r["index"] for r in line["device"]["by_rank"]] == list(range(n))
    assert line["device"]["memory_peak_bytes"] == max(
        r["memory_peak_bytes"] for r in line["device"]["by_rank"])
    assert all(r["busy_s"] > 0 for r in line["device"]["by_rank"])


@pytest.mark.card
def test_an_idle_card_is_not_counted(card, tmp_path):
    """Rank 1 allocates nothing on its card and only waits out its
    window: the line counts every card but that one."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards; this machine has one")
    bench, roots = toy_cells(tmp_path, n, "idle", 1)
    line = run.launch(bench, "toy.cards", 2 ** 31 + 29, 2.0, False, n,
                      "cuda", roots)
    print(json.dumps(line["device"]))
    assert line["device"]["count"] == n - 1
    assert [r["index"] for r in line["device"]["by_rank"]] == list(range(n))


@pytest.mark.card
def test_memory_held_before_the_reset_counts_no_card(card):
    """A card counts where this process's peak rose above what it held
    when the peaks were reset, not where it only still holds that."""
    before = torch.ones(1 << 20, device=card)
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    base = run._allocated(card)
    assert torch.cuda.max_memory_allocated(card) >= before.numel() * 4
    assert run._cards(card, base) == {}
    after = torch.ones(1 << 20, device=card)
    assert list(run._cards(card, base).values()) == [
        torch.cuda.max_memory_allocated(card)]
    del before, after
