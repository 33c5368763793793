"""The port's spans (``ranklib_tpu_torch.utils.trace``) and the benchmark's
metrics that read them (``ltrbench/layer_metrics``), on the CPU.

* Without a profiler ``span`` is one shared null context and never
  builds a ``record_function``.
* Under the profiler a LambdaMART round is one ``ranklib.step`` holding
  its phases, growth one ``grow.root`` and a ``grow.split`` a split, and
  a silent round reads nothing back; a dense Random Forests fit opens one
  ``fit.setup`` with its five phases (the fused ``fit.bin_T``, no
  ``fit.pad`` or ``fit.transpose``) and reads the trees back once a
  group of bags.
* The four metrics read known values from a hand-made trace, leave out
  the harness's own launches and read nothing from a program without
  spans.
* Trees and scores are the same bits with and without the profiler.
"""

import contextlib
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ltrbench.layer_metrics.program import Program
from ltrbench.trace import Trace, profiled
from ranklib_tpu_torch.data.dataset import Dataset, Query
from ranklib_tpu_torch.metrics.base import create_scorer
from ranklib_tpu_torch.models import rf as PRF
from ranklib_tpu_torch.models.gbdt import LambdaMART
from ranklib_tpu_torch.utils import trace as T
from ranklib_tpu_torch.utils.logging import set_silent

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND = ("round.lambdas", "round.grow", "round.leaf_outputs",
         "round.score_update", "round.validate", "round.record")
SETUP = ("fit.bin", "fit.bin_T", "fit.upload", "fit.bag_draws",
         "fit.doc_map")


@pytest.fixture(autouse=True)
def _port_defaults():
    set_silent(False)
    yield
    set_silent(False)


def _ds(seed: int, n_queries: int = 10, n_features: int = 6) -> Dataset:
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(99).normal(size=n_features)
    qs = []
    for i in range(n_queries):
        n = int(rng.integers(4, 14))
        x = rng.normal(size=(n, n_features)).astype(np.float32)
        y = np.clip(np.round(x @ w + rng.normal(size=n)), 0, 4)
        qs.append(Query(str(i + 1), y.astype(np.float32), x))
    return Dataset(qs, n_features)


def _lambdamart(**hp):
    return LambdaMART(**{"n_trees": 3, "n_leaves": 4, "early_stop": 0,
                         **hp})


def _within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _metric(name: str):
    path = os.path.join(ROOT, "ltrbench", "layer_metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "_test_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


METRICS = ("step.launches", "validate.launches", "call.host_reads",
           "fit.setup_s")


# ---- the helper -------------------------------------------------------------

def test_span_is_the_shared_null_context_without_a_profiler(monkeypatch):
    assert T.span("step") is T.span("grow.split")

    def refuse(*a, **k):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    set_silent(True)
    _lambdamart().fit(_ds(1), create_scorer("NDCG@10"), _ds(2), device=CPU)


def test_span_records_under_the_profiler():
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with T.span("phase"):
            torch.ones(3).sum()
    names = [e.key for e in prof.key_averages()]
    assert "ranklib.phase" in names


# ---- LambdaMART rounds --------------------------------------------------------

def _profiled_fit(ranker, silent: bool, validation=True) -> Program:
    set_silent(silent)
    train, vali = _ds(3), (_ds(4) if validation else None)
    with profiled(cuda=False) as box:
        ranker.fit(train, create_scorer("NDCG@10"), vali, device=CPU)
    return Program(box["trace"])


def test_a_silent_round_is_one_step_holding_its_phases():
    n_trees, n_leaves = 3, 4
    p = _profiled_fit(_lambdamart(n_trees=n_trees, n_leaves=n_leaves), True)
    steps = p.spans["step"]
    assert len(steps) == n_trees
    for name in ROUND:
        spans = p.spans[name]
        assert len(spans) == n_trees, name
        for s in steps:
            assert sum(_within(x, s) for x in spans) == 1, name
    assert "round.train_metric" not in p.spans       # silent: no table
    for s in steps:
        grow = [g for g in p.spans["round.grow"] if _within(g, s)][0]
        assert sum(_within(x, grow) for x in p.spans["grow.root"]) == 1
        assert sum(_within(x, grow)
                   for x in p.spans["grow.split"]) == n_leaves - 1
    assert p.count("prepare") == 1
    for name in ("prepare.bin", "prepare.pad", "prepare.validation_bins",
                 "prepare.upload", "prepare.buckets"):
        assert _within(p.spans[name][0], p.spans["prepare"][0]), name
    reads = p.spans.get("host_read", [])
    assert reads                                      # export, impacts
    assert not any(_within(r, s) for r in reads for s in steps)


@pytest.mark.parametrize("validation", [True, False])
def test_a_round_with_its_table_reads_the_device(validation):
    n_trees = 3
    p = _profiled_fit(_lambdamart(n_trees=n_trees), False, validation)
    steps = p.spans["step"]
    assert p.count("round.train_metric") == n_trees
    assert p.count("round.validate") == (n_trees if validation else 0)
    reads = p.spans["host_read"]
    between = [r for r in reads if steps[0][1] <= r[0] < steps[-1][1]]
    assert len(between) >= n_trees - 1                # a line a round
    assert not any(_within(r, s) for r in reads for s in steps)


# ---- Random Forests -----------------------------------------------------------

@pytest.mark.parametrize("group_bags,groups", [(6, 1), (2, 3)])
def test_a_forest_fit_opens_one_setup_and_reads_a_group_once(
        monkeypatch, group_bags, groups):
    monkeypatch.setattr(PRF, "bag_group_size", lambda *a: group_bags)
    set_silent(True)
    rf = PRF.RFRanker(n_bags=6, n_leaves=4)
    with profiled(cuda=False) as box:
        rf.fit(_ds(5), create_scorer("NDCG@10"), device=CPU)
    p = Program(box["trace"])
    assert p.count("fit.setup") == 1
    setup = p.spans["fit.setup"][0]
    for name in SETUP:
        assert p.count(name) == 1, name
        assert _within(p.spans[name][0], setup), name
    for name in ("fit.pad", "fit.transpose"):       # the pre-binned route's
        assert not p.count(name), name
    assert p.count("rf.group") == groups
    assert p.count("step") == groups
    for g in p.spans["rf.group"]:
        for name in ("rf.doc_w", "step", "rf.export", "host_read"):
            assert sum(_within(x, g) for x in p.spans[name]) == 1, name
    obs = SimpleNamespace(trace=box["trace"], traced_calls=1)
    assert _metric("call.host_reads").read(obs) == groups
    assert _metric("fit.setup_s").read(obs) > 0
    assert _metric("validate.launches").read(obs) is None


def test_a_per_bag_forest_fit_opens_a_group_a_bag():
    set_silent(True)
    rf = PRF.RFRanker(n_bags=3, n_leaves=4, ranker_type=6, n_trees=2)
    with profiled(cuda=False) as box:
        rf.fit(_ds(6), create_scorer("NDCG@10"), device=CPU)
    p = Program(box["trace"])
    assert p.count("fit.setup") == 1
    assert p.count("rf.group") == 3
    assert p.count("step") == 3 * 2
    assert p.count("host_read") == 3                  # a bag's export


# ---- the metrics on a hand-made trace -----------------------------------------

def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


def _events(with_program: bool) -> list:
    ua = "user_annotation"
    ev = [_x("ltrbench.window", ua, 0, 1000),
          _x("ltrbench.step", ua, 5, 100),
          _x("ltrbench.count", ua, 25, 10),
          _x("cudaLaunchKernel", "cuda_runtime", 20, 1),
          _x("cudaLaunchKernel", "cuda_runtime", 30, 1),     # harness's
          _x("cudaLaunchKernel", "cuda_runtime", 60, 1),
          _x("cudaLaunchKernelExC", "cuda_runtime", 70, 1),
          _x("cuLaunchKernel", "cuda_driver", 210, 1),
          _x("cudaGraphLaunch", "cuda_runtime", 250, 1),
          _x("cudaMemcpyAsync", "cuda_runtime", 255, 1),     # no launch
          _x("cudaLaunchKernel", "cuda_runtime", 500, 1),    # no step
          _x("aten::add", "cpu_op", 59, 3)]
    if with_program:
        ev += [_x("ranklib.step", ua, 10, 90),
               _x("ranklib.round.validate", ua, 50, 40),
               _x("ranklib.step", ua, 200, 100),
               _x("ranklib.round.validate", ua, 240, 20),
               _x("ranklib.host_read", ua, 400, 10),
               _x("ranklib.host_read", ua, 420, 10),
               _x("ranklib.fit.setup", ua, 600, 200),
               _x("ranklib.fit.bin", ua, 610, 50),
               _x("ranklib.fit.setup", ua, 850, 50)]
    return ev


def test_the_metrics_read_a_hand_made_trace():
    obs = SimpleNamespace(trace=Trace(_events(True)), traced_calls=2)
    got = {m: _metric(m).read(obs) for m in METRICS}
    # launches in the steps: 20, 60, 70 and 210, 250 (30 is the harness's)
    assert got["step.launches"] == 2.5
    assert got["validate.launches"] == 1.5            # 60, 70 and 250
    assert got["call.host_reads"] == 1.0              # 2 reads, 2 calls
    assert got["fit.setup_s"] == pytest.approx(125e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_a_metric_reads_nothing_without_the_programs_spans(metric):
    mod = _metric(metric)
    assert mod.read(SimpleNamespace(trace=Trace(_events(False)),
                                    traced_calls=2)) is None
    assert mod.read(SimpleNamespace(trace=None, traced_calls=0)) is None


# ---- the spans change nothing -------------------------------------------------

def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("silent", [True, False])
def test_lambdamart_is_the_same_bits_under_the_profiler(silent):
    set_silent(silent)
    out = []
    for traced in (False, True):
        ranker = _lambdamart(n_trees=4)
        with (_cpu_profile() if traced else contextlib.nullcontext()):
            ranker.fit(_ds(7), create_scorer("NDCG@10"), _ds(8), device=CPU)
        out.append((ranker.model_str(),
                    ranker.fit_state.scores.numpy().tobytes(),
                    ranker.fit_state.vscores.numpy().tobytes()))
    assert out[0] == out[1]


@pytest.mark.parametrize("rtype", [0, 6])
def test_random_forests_is_the_same_bits_under_the_profiler(rtype):
    set_silent(True)
    out = []
    for traced in (False, True):
        rf = PRF.RFRanker(n_bags=4, n_leaves=4, ranker_type=rtype)
        with (_cpu_profile() if traced else contextlib.nullcontext()):
            rf.fit(_ds(9), create_scorer("NDCG@10"), device=CPU)
        out.append(rf.model_str())
    assert out[0] == out[1]
