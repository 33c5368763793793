"""The benchmark of ``ranklib_tpu_torch`` on NVIDIA GPUs: one cell, one
run, one JSON line.

    python3 -m ltrbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration
(``ltrbench/configs/<config>.json``: the ranker, its parameters, the
driver that runs it) and a traffic mix (``ltrbench/traffic/<mix>.json``:
the shape of the training set that ``ltrbench.gen`` draws from the
seed). The run generates the data on the card, builds and warms the
program (set-up), drives the configuration's driver for ``--seconds``
(the window), and with ``--trace 1`` traces a span after it for the
per-layer metrics (``ltrbench/layer_metrics/<metric>.py``). It then
frees the program's state, judges what the program produced against the
plain reference (``ltrbench/reference``) within the cell's limits
(``ltrbench/limits/<cell>.json``) and prints the line last.

``setup_s`` is everything before the window, a checkout's first run's
build of the port's libraries with it; ``build_s`` in the line gives
that build (or, once built, the load) apart.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache a program may keep (Triton's, torch
# extensions', the CUDA driver's JIT cache) at fixed paths inside the
# checkout, so that a checkout's first run builds and the others find
# everything built; the port's own libraries build into its _build/
CACHE = os.path.join(ROOT, ".ltrbench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)

import torch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ranklib_tpu")


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def find(roots, kind: str, name: str, ext: str) -> str:
    """``<root>/<kind>/<name><ext>`` in the first of ``roots`` (a list of
    directories laid out as this one) that holds it."""
    for root in roots:
        path = os.path.join(root, kind, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {kind}/{name}{ext} under {list(roots)}")


def load_json(roots, kind: str, name: str) -> dict:
    with open(find(roots, kind, name, ".json")) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(roots, name: str):
    """The per-layer metric's module, ``layer_metrics/<name>.py``."""
    return _module(find(roots, "layer_metrics", name, ".py"),
                   f"ltrbench.layer_metrics._{name.replace('.', '_')}")


def load_driver(roots, name: str):
    """The driver's module, ``drivers/<name>.py``."""
    return _module(find(roots, "drivers", name, ".py"),
                   f"ltrbench.drivers._{name}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


class Observations:
    """What the per-layer metrics read."""

    def __init__(self):
        self.trace = None
        self.traced_calls = 0         # the program's calls in the trace
        self.window_calls = 0         # ... and in the untraced window
        self.window_s = 0.0
        self.calls = []               # the reading metric's call counts
        self.call_gaps_ms = []
        self.prep_s = None
        self.peak = None


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The cell's metrics of ``kind`` (end_to_end or per_layer)."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device: torch.device, roots=(HERE,),
             t_start: float = T_START) -> dict:
    """One run of a cell on ``device``: the result line as a dict. The
    cell's files are looked up in ``roots`` in order."""
    from ltrbench import gen, trace as tr
    from ltrbench.drivers.common import sync, wrapped
    from ltrbench.reference.judge import Context

    cell = find_cell(bench, cell_name)
    cfg = load_json(roots, "configs", cell["config"])
    traffic = load_json(roots, "traffic", cell["traffic"])
    limits = load_json(roots, "limits", cell_name)
    driver = load_driver(roots, cfg["driver"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = 0.0
    if device.type == "cuda":
        torch.cuda.set_device(device)
        from ranklib_tpu_torch.ops._build import build_all

        t0 = time.perf_counter()
        build_all()
        build_s = time.perf_counter() - t0
    train, vali = gen.generate(traffic, seed, device,
                               with_validation=bool(cfg.get("validation")))
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    sut = driver.Driver(cfg, train, vali, device)
    sync(device)
    setup_s = time.perf_counter() - t_start

    win = sut.window(seconds, events=trace and device.type == "cuda")
    obs = Observations()
    per_layer = cell_metrics(bench, cell_name, "per_layer")
    dev_info = {}
    breakdown = None
    if trace:
        mods = {m["name"]: load_metric(roots, m["name"]) for m in per_layer}
        counters = {}
        for name, mod in mods.items():
            if hasattr(mod, "count"):
                counters.setdefault(mod.SPAN, []).append((name, mod.count))
        rec = tr.Recorder(counters, device)
        obs.prep_s = getattr(sut, "prep_s", None)
        obs.window_calls, obs.window_s = win.calls, win.seconds
        if win.ends:
            obs.call_gaps_ms = [a.elapsed_time(b)
                                for a, b in zip(win.ends, win.ends[1:])]
        with wrapped(sut.spans(), rec.wrap):
            with tr.profiled(cuda=device.type == "cuda") as box:
                obs.traced_calls = sut.traced_calls()
        obs.trace = box["trace"]
        sync(device)
        calls = rec.resolved()
        obs.peak = _peak(device)
        dev_info = {"busy_s": obs.trace.busy_s,
                    "window_s": obs.trace.window_s}
        breakdown = {"device_ops": [list(x) for x in obs.trace.device_ops()],
                     "idle_gaps": [list(x) for x in obs.trace.idle_gaps()]}
        metrics = {}
        for m in per_layer:
            obs.calls = calls.get(m["name"], [])
            v = mods[m["name"]].read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "train_rate": win.work / win.seconds}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell_metrics(bench, cell_name, "end_to_end")}
    peak_bytes = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    outputs = sut.outputs()
    sut.close()
    del sut
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx = Context(train, vali, int(cfg["params"]["n_threshold"]), device)
    nums = driver.judge(ctx, outputs, cfg, seed)
    # a reading that is not a number fails: only v <= limit passes
    failed = sum(not (v <= limits[k]) for k, v in nums.items())
    checks = {k: {"value": _json_number(v), "limit": limits[k]}
              for k, v in nums.items()}
    line = {"correct": failed == 0, "attempted": win.calls,
            "failed": int(failed), "metrics": metrics,
            "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                       "kind": (torch.cuda.get_device_name(device)
                                if device.type == "cuda" else "cpu"),
                       "count": 1, "memory_peak_bytes": int(peak_bytes),
                       **dev_info}}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["build_s"] = build_s
    line["checks"] = checks
    return line


def _json_number(v):
    """``v``, or its name ("nan", "inf") where it is not finite, which
    JSON cannot hold."""
    return v if math.isfinite(v) else repr(float(v))


def _peak(device):
    if device.type != "cuda":
        return None
    with open(os.path.join(HERE, "peaks.json")) as f:
        peaks = json.load(f)
    return peaks.get(torch.cuda.get_device_name(device))


def parse(argv):
    p = argparse.ArgumentParser(prog="ltrbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = load_bench()
    cell = find_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"ltrbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    line = run_cell(bench, args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"ltrbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
