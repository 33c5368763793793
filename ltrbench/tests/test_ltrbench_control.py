"""The comparison that decides ``correct`` fails what it must: the
control (the reference in the program's place, in bfloat16, the
precision below the configurations' float32) and each fault of the
timed path that a one-card training cell can have, planted under a
whole run that skips only the look for a card. Tiny cells on the CPU,
held to the real cells' limits."""

import pytest
import torch

from ltrbench import run
from ltrbench.faults import FAULTS, fault
from ltrbench.reference.judge import Context
from ltrbench_cells import tiny_cells

CELLS = ("lambdamart.tiny", "rf.tiny")
SEED = 2 ** 31 + 77


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path):
    bench, roots = tiny_cells(tmp_path)
    line = run.run_cell(bench, cell, SEED, 0.3, False, torch.device("cpu"),
                        roots=roots)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("name", FAULTS)
def test_fault_is_not_correct(cell, name, tmp_path):
    bench, roots = tiny_cells(tmp_path)
    cfg = run.load_json(roots, "configs", run.find_cell(bench,
                                                        cell)["config"])
    with fault(cfg["driver"], name):
        line = run.run_cell(bench, cell, SEED, 0.3, False,
                            torch.device("cpu"), roots=roots)
    assert not line["correct"], line["checks"]
    assert line["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tmp_path):
    from ltrbench import gen

    bench, roots = tiny_cells(tmp_path)
    c = run.find_cell(bench, cell)
    cfg = run.load_json(roots, "configs", c["config"])
    limits = run.load_json(roots, "limits", cell)
    driver = run.load_driver(roots, cfg["driver"])
    dev = torch.device("cpu")
    train, vali = gen.generate(run.load_json(roots, "traffic",
                                             c["traffic"]), SEED, dev,
                               with_validation=bool(cfg.get("validation")))
    ctx = Context(train, vali, int(cfg["params"]["n_threshold"]), dev)
    nums = driver.judge(ctx, driver.control(ctx, cfg, SEED, torch.bfloat16),
                        cfg, SEED)
    assert any(v > limits[k] for k, v in nums.items()), nums
    # the same reference in float64 in the program's place passes
    nums = driver.judge(ctx, driver.control(ctx, cfg, SEED, torch.float64),
                        cfg, SEED)
    assert all(v <= limits[k] for k, v in nums.items()), nums
