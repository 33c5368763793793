"""Tiny cells for the CPU tests: the benchmark's own configurations on a
small traffic mix, laid out as a directory of new files that the harness
searches before its own."""

import json
import os

from ltrbench import run

TINY_TRAFFIC = {
    "source": "a small synthetic mix for tests",
    "train_queries": 40, "validation_queries": 12, "features": 6,
    "presence": 1.0, "grades": 5, "signal": 2.5,
    "docs_per_query": {"mean": 20, "sigma": 0.63, "min": 1, "max": 60},
}


def write(root, kind: str, name: str, obj) -> None:
    os.makedirs(os.path.join(root, kind), exist_ok=True)
    with open(os.path.join(root, kind, f"{name}.json"), "w") as f:
        json.dump(obj, f)


def tiny_cells(tmp_path) -> tuple:
    """(bench, roots): the benchmark with cells ``lambdamart.tiny`` and
    ``rf.tiny`` (12 bags) on the tiny mix, held to the real cells'
    limits."""
    root = str(tmp_path)
    bench = run.load_bench()
    write(root, "traffic", "tiny", TINY_TRAFFIC)
    rf = run.load_json((run.HERE,), "configs", "rf")
    rf["params"]["n_bags"] = 12
    write(root, "configs", "rf_tiny", rf)
    for name, config, real in (("lambdamart.tiny", "lambdamart",
                                "lambdamart.mslr30k"),
                               ("rf.tiny", "rf_tiny", "rf.mslr30k")):
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "tests"})
        write(root, "limits", name,
              run.load_json((run.HERE,), "limits", real))
    return bench, (root, run.HERE)
