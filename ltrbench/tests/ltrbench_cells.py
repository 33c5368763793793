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


TOY_DRIVER = '''"""A toy multi-card driver: each worker joins the program's group from
the launcher's environment (``ranklib_tpu_torch.parallel.dist.join``)
and all-reduces one tensor a call, which carries each rank's "my time is
up" as well, so that every rank ends its window at the same call.
``params.fault`` on ``params.fault_rank``: "raise_setup", "raise_window",
"stall" (never ends set-up), "wrong" (outputs a wrong sum), "forbidden"
(loads a module named jax) or "idle" (no rank joins: the others work
alone, the fault rank allocates nothing and only waits out its window)."""

import os
import sys
import time
import types

import torch

from ltrbench.drivers.common import Window, sync


class Driver:
    def __init__(self, cfg, train, vali, device):
        from ranklib_tpu_torch.parallel import dist

        p = cfg["params"]
        self.rank = int(os.environ["RANK"])
        self.world = int(os.environ["WORLD_SIZE"])
        self.device = device
        self.fault = p["fault"] if self.rank == p["fault_rank"] else None
        self.joined = p["fault"] != "idle"
        if self.joined:
            self.rank, self.world, self.device = dist.join(device=device)
        self.env = {k: os.environ[k] for k in (
            "RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR")}
        if self.fault == "raise_setup":
            raise RuntimeError(f"toy fault in rank {self.rank}'s set-up")
        if self.fault == "stall":
            time.sleep(3600)
        if self.fault == "forbidden":
            sys.modules["jax"] = types.ModuleType("jax")
        self.held = (None if self.fault == "idle"
                     else torch.ones(1 << 16, device=self.device))
        self.total = None

    def call(self, done=False):
        """One all-reduce; true when some rank's time is up."""
        if self.fault == "raise_window":
            raise RuntimeError(f"toy fault in rank {self.rank}'s window")
        if self.fault == "idle":
            return done
        y = torch.ones(2, device=self.device)
        y[1] = float(done)
        if self.joined:
            torch.distributed.all_reduce(y)
        self.total = y
        return bool(y[1] > 0)

    def window(self, seconds, events=False):
        sync(self.device)
        t0 = time.perf_counter()
        n = 0
        while not self.call(time.perf_counter() - t0 >= seconds):
            n += 1
        n += 1
        sync(self.device)
        return Window(n, float(n), time.perf_counter() - t0)

    def traced_calls(self):
        self.call()
        return 1

    def spans(self):
        return []

    def outputs(self):
        return {"rank": self.rank, "world": self.world, "env": self.env,
                "sum": float(self.total[0]) + (self.fault == "wrong")}

    def close(self):
        self.held = self.total = None
        if self.joined:
            torch.distributed.destroy_process_group()


def judge(ctx, outputs, cfg, seed):
    env = outputs["env"]
    torchrun = (env["RANK"] == env["LOCAL_RANK"] == str(outputs["rank"])
                and env["WORLD_SIZE"] == env["LOCAL_WORLD_SIZE"]
                == str(outputs["world"]) and env["MASTER_ADDR"] == "127.0.0.1")
    return {"judged_on": float(os.environ["RANK"]),
            "outputs_of": float(outputs["rank"]),
            "env_gap": float(not torchrun),
            "sum_gap": abs(outputs["sum"] - outputs["world"])}
'''


def toy_cells(tmp_path, chips: int, fault=None, fault_rank: int = 1) -> tuple:
    """(bench, roots): the benchmark with a cell ``toy.cards`` on
    ``chips`` cards that runs :data:`TOY_DRIVER` on the tiny mix."""
    root = str(tmp_path)
    bench = run.load_bench()
    write(root, "traffic", "tiny", TINY_TRAFFIC)
    write(root, "configs", "toy", {
        "driver": "toy", "params": {"n_threshold": 8, "fault": fault,
                                    "fault_rank": fault_rank}})
    os.makedirs(os.path.join(root, "drivers"), exist_ok=True)
    with open(os.path.join(root, "drivers", "toy.py"), "w") as f:
        f.write(TOY_DRIVER)
    bench["workloads"].append({"name": "toy.cards", "config": "toy",
                               "traffic": "tiny", "chips": chips,
                               "why": "tests"})
    write(root, "limits", "toy.cards", {"judged_on": 0, "outputs_of": 0,
                                        "env_gap": 0, "sum_gap": 0})
    return bench, (root, run.HERE)
