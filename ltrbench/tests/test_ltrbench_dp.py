"""The data-parallel LambdaMART driver (``drivers/boost_rounds_dp.py``)
on the CPU: a tiny cell of two gloo ranks through the launcher
(``run.launch``), built under the test's directory as
``ltrbench_cells.py`` builds its cells; ``BENCHMARK.json`` is not
touched.

Faults, planted by a driver written beside the cell (``dp_faults``: the
real driver with one change) on every rank or on rank 1 alone:

* ``unsummed``: ``sum_across`` returns its tensor unreduced, wherever the
  round looks it up, on every rank: each rank grows its own trees;
* ``altered``: ``faults.py``'s ``altered`` (the largest leaf of each tree
  1% larger) on rank 1 only;
* ``fewer``: rank 1's window records one round fewer (its first window
  round's tree is written over by the next; its scores keep both);
* ``ends_early``: rank 1 ends its window after one round while rank 0
  goes on: rank 0's next collective fails once rank 1 leaves the group,
  and the run ends without a line.
"""

import argparse
import json
import math
import os
import time

import pytest
import torch

from ltrbench import run
from ltrbench_cells import TINY_TRAFFIC, write

CELL = "lambdamart.tiny-dp2"
DP4 = "lambdamart.mslr30k-dp4"

FAULT_DRIVER = '''"""boost_rounds_dp with one fault (``params.fault``) on every rank
(unsummed) or on ``params.fault_rank``."""

import os

from ltrbench.drivers import boost_rounds_dp
from ltrbench.drivers.boost_rounds_dp import control, judge  # noqa: F401


class Driver(boost_rounds_dp.Driver):
    def __init__(self, cfg, train, vali, device):
        from ltrbench.faults import boost_fault
        from ranklib_tpu_torch.gbdt import boost, grow

        fault = cfg["fault"]
        here = int(os.environ["RANK"]) == cfg["fault_rank"]
        self.fault = fault if (here or fault == "unsummed") else None
        if self.fault == "unsummed":
            boost.sum_across = grow.sum_across = lambda x, group: x
        elif self.fault == "altered":
            self.planted = boost_fault("altered")    # held: its exit undoes
            self.planted.__enter__()
        self.window_rounds = 0
        super().__init__(cfg, train, vali, device)

    def window(self, seconds, events=False):
        self.window_rounds = 1
        return super().window(seconds, events)

    def call(self):
        t = self.t
        super().call()
        if self.window_rounds:
            self.window_rounds += 1
            if self.fault == "fewer" and self.window_rounds == 2:
                self.t = t                 # the round's record goes
        if self.fault == "ends_early" and self.window_rounds == 2:
            self._is_up = lambda pending: True
'''


def dp_cells(tmp_path, fault=None) -> tuple:
    """(bench, roots): the benchmark with the cell ``lambdamart.tiny-dp2``
    (the dp configuration at ``dp`` 2, its driver or ``dp_faults``) on the
    tiny mix, held to ``lambdamart.mslr30k-dp4``'s limits and reporting
    its per-layer metrics."""
    root = str(tmp_path)
    bench = run.load_bench()
    write(root, "traffic", "tiny", TINY_TRAFFIC)
    cfg = run.load_json((run.HERE,), "configs", "lambdamart-dp4")
    cfg["dp"] = 2
    if fault:
        cfg.update(driver="dp_faults", fault=fault, fault_rank=1)
        os.makedirs(os.path.join(root, "drivers"), exist_ok=True)
        with open(os.path.join(root, "drivers", "dp_faults.py"), "w") as f:
            f.write(FAULT_DRIVER)
    write(root, "configs", "lambdamart_dp_tiny", cfg)
    bench["workloads"].append({"name": CELL, "config": "lambdamart_dp_tiny",
                               "traffic": "tiny", "chips": 2,
                               "why": "tests"})
    for m in bench["per_layer"]:
        if DP4 in m["workloads"]:
            m["workloads"] = m["workloads"] + [CELL]
    write(root, "limits", CELL,
          run.load_json((run.HERE,), "limits", "lambdamart.mslr30k-dp4"))
    return bench, (root, run.HERE)


def _execute(bench, roots, capfd, trace=0, seed=2 ** 31 + 41):
    """``ltrbench.run`` on the cell, on the CPU: (exit code, the line or
    None, standard error, seconds)."""
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=0.5,
                              trace=trace)
    t0 = time.perf_counter()
    rc = run.execute(bench, args, roots=roots, platform="cpu")
    took = time.perf_counter() - t0
    out, err = capfd.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) <= 1
    return rc, (json.loads(lines[0]) if lines else None), err, took


@pytest.mark.parametrize("trace", [0, 1])
def test_dp_cell_is_correct(tmp_path, capfd, trace):
    """Two ranks: one line, ``correct``, every check at 0 ranks apart;
    traced, the collectives a round on rank 0: the root's histogram and
    sum, a histogram and a sum for each of the 8 splits that build
    children, the leaf sums and the validation metric (20); no host read
    in the traced span (the ranks' parts travel after it); on the CPU
    only the metrics that read no device time or kernel."""
    bench, roots = dp_cells(tmp_path)
    rc, line, err, _ = _execute(bench, roots, capfd, trace)
    assert rc == 0 and line is not None, err
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"split_gap", "grid_miss", "leaf_err",
                                   "score_err", "val_err", "rank_mismatch"}
    assert line["checks"]["rank_mismatch"]["value"] == 0
    assert [r["rank"] for r in line["device"]["by_rank"]] == [0, 1]
    assert line["attempted"] >= 1
    if trace:
        assert set(line["metrics"]) == {
            "prep_s", "device.idle_pct", "step.launches",
            "validate.launches", "call.host_reads", "all_reduce.calls"}
        assert line["metrics"]["all_reduce.calls"]["value"] == 20.0
        assert line["metrics"]["call.host_reads"]["value"] == 0.0
    else:
        assert list(line["metrics"]) == ["setup_s", "train_rate"]


@pytest.mark.parametrize("fault", ["unsummed", "altered", "fewer"])
def test_dp_fault_is_not_correct(tmp_path, capfd, fault):
    """Each fault prints a line that is not ``correct``; where the ranks'
    trees part, ``rank_mismatch`` counts rank 1."""
    bench, roots = dp_cells(tmp_path, fault)
    rc, line, err, _ = _execute(bench, roots, capfd)
    assert rc == 0 and line is not None, err
    assert not line["correct"] and line["failed"] >= 1, line["checks"]
    assert line["checks"]["rank_mismatch"]["value"] == 1


def test_dp_rank_that_ends_early_fails_the_run(tmp_path, capfd):
    """A rank that ends its window before the others leaves rank 0 in a
    collective it cannot finish: the run ends soon, non-zero, with no
    line."""
    bench, roots = dp_cells(tmp_path, "ends_early")
    rc, line, err, took = _execute(bench, roots, capfd)
    assert rc != 0 and line is None
    assert "rank 0 failed" in err
    assert took < 120


class _Trace:
    span_counts = {"step": 2}

    def __init__(self, kernels):
        self._k = kernels

    def kernels(self, span):
        return self._k if span == "all_reduce" else []


def test_collective_metrics_read_their_inputs(monkeypatch):
    """The collective metrics pair each call with its NCCL kernel (other
    kernels under the span are not the collective's): 2 rounds of a
    100-byte and an 8-byte call, kernels of 3, 1, 2, 4 ms; a call's own
    time is the least of its size's (2 and 1 ms), so 3 ms own and 2 ms of
    waits a round; a ring over 4 ranks moves 1.5x the bytes reduced.
    A size whose calls all waited takes the bound of a larger size's
    (8-byte calls of 5 and 6 ms beside 100-byte ones of 2 and 3 ms: 2 ms
    own). None without kernels, or without one kernel a call, and the
    share None where the card's link is not listed (on the CPU)."""
    ms = run.load_metric((run.HERE,), "all_reduce.device_ms")
    wait = run.load_metric((run.HERE,), "all_reduce.wait_ms")
    roof = run.load_metric((run.HERE,), "all_reduce_roofline")
    obs = run.Observations()
    assert ms.read(obs) is None and wait.read(obs) is None
    assert roof.read(obs) is None
    obs.trace = _Trace([("ncclDevKernel_AllReduce", 3e-3), ("copy", 9e-3),
                        ("ncclDevKernel_AllReduce", 1e-3),
                        ("ncclDevKernel_AllReduce", 2e-3),
                        ("ncclDevKernel_AllReduce", 4e-3)])
    obs.calls = [{"bytes": 100, "n": 4}, {"bytes": 8, "n": 4}] * 2
    assert ms.read(obs) == pytest.approx(3.0)
    assert wait.read(obs) == pytest.approx(2.0)
    assert roof.work(obs.calls[0]) == pytest.approx(150)
    if not torch.cuda.is_available():
        assert roof.peak() is None and roof.read(obs) is None
    monkeypatch.setattr(roof, "peak", lambda: 450e9)
    assert roof.read(obs) == pytest.approx(100 * 324 / 450e9 / 6e-3)
    obs.trace = _Trace([("ncclDevKernel_AllReduce", t)
                        for t in (2e-3, 5e-3, 3e-3, 6e-3)])
    assert ms.read(obs) == pytest.approx(4.0)
    assert wait.read(obs) == pytest.approx(4.0)
    obs.calls = obs.calls[:3]
    assert ms.read(obs) is None and wait.read(obs) is None
    assert roof.read(obs) is None
    obs.trace = _Trace([])
    assert ms.read(obs) is None and roof.read(obs) is None
    assert not math.isnan(roof.work({"bytes": 4, "n": 1}))
