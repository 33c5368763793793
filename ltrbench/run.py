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

A cell whose ``chips`` is n > 1 runs as users run ``-dp`` under
``torchrun``: :func:`launch` starts one worker process a card (worker r
on ``cuda:r``, with ``RANK`` = ``LOCAL_RANK`` = r, ``WORLD_SIZE`` =
``LOCAL_WORLD_SIZE`` = n, ``MASTER_ADDR`` and a free ``MASTER_PORT``),
and the program joins its group from them
(``ranklib_tpu_torch.parallel.dist.join``); the harness opens no group
of its own and meets its workers through pipes. Every worker runs the
phases above on its card; all start the window at one barrier, and
``setup_s`` runs from the launcher's start to it. Once every worker has
freed its state, rank 0 judges. The launcher prints one line: rank 0's
metrics, trace, breakdown and judge, ``device.count`` the distinct cards
on which the program allocated memory of its own in set-up and window
(a worker's peak there rose above what it held when the peaks were
reset), ``memory_peak_bytes`` the fullest card's, and ``device.by_rank``
each worker's current card, peak and (traced) busy and window seconds.
A worker that raises, dies, or misses a barrier by its bound
(``SETUP_WAIT_S``, ``WINDOW_WAIT_S``, ``JUDGE_WAIT_S``) fails the run:
the others are ended, and no line is printed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import multiprocessing  # noqa: E402
import multiprocessing.connection  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

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

# a multi-card run fails when a worker has not finished set-up this many
# seconds after the launcher started it, its window (with the traced span
# and the freeing of its state) this many seconds past ``--seconds``, or
# rank 0 its judge (and every worker its line) this many seconds after the
# launcher asked for it
SETUP_WAIT_S = 480.0
WINDOW_WAIT_S = 240.0
JUDGE_WAIT_S = 240.0


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
             t_start: float = T_START, meet=None,
             judge: bool = True) -> dict:
    """One run of a cell on ``device``: the result line as a dict. The
    cell's files are looked up in ``roots`` in order.

    A worker of a multi-card run passes ``meet(phase)``, called when
    set-up has ended (``"set up"``) and when the program's state is freed
    (``"freed"``), and returning when the launcher lets the run go on;
    its line also carries ``device.cards`` (see :func:`_cards`) and
    ``device.index``, the card it reads as current at the window's end.
    Only rank 0 runs with ``judge``."""
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
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)
    base = _allocated(device)
    sut = driver.Driver(cfg, train, vali, device)
    sync(device)
    setup_s = time.perf_counter() - t_start
    if meet is not None:
        meet("set up")

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
    held = _cards(device, base)
    index = torch.cuda.current_device() if device.type == "cuda" else None
    outputs = sut.outputs() if judge else None
    sut.close()
    del sut
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if meet is not None:
        meet("freed")
    nums = {}
    if judge:
        ctx = Context(train, vali, int(cfg["params"]["n_threshold"]),
                      device)
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
                       "count": len(held),
                       "memory_peak_bytes": int(peak_bytes),
                       **dev_info}}
    if meet is not None:
        line["device"].update(cards=held, index=index)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["build_s"] = build_s
    line["checks"] = checks
    return line


def _json_number(v):
    """``v``, or its name ("nan", "inf") where it is not finite, which
    JSON cannot hold."""
    return v if math.isfinite(v) else repr(float(v))


def _allocated(device) -> dict:
    """{card index: bytes this process holds on it now}."""
    if device.type != "cuda":
        return {}
    return {i: torch.cuda.memory_allocated(i)
            for i in range(torch.cuda.device_count())}


def _cards(device, base: dict) -> dict:
    """{card: this process's peak bytes on it} over the cards on which
    its peak rose above ``base`` (:func:`_allocated` when the peaks were
    reset): where the program allocated memory of its own, not only held
    what was there before. A card is told apart by its uuid; the CPU
    counts as one card."""
    if device.type != "cuda":
        return {"cpu": 0}
    held = {}
    for i, before in base.items():
        peak = torch.cuda.max_memory_allocated(i)
        if peak > before:
            props = torch.cuda.get_device_properties(i)
            held[str(getattr(props, "uuid", f"cuda:{i}"))] = int(peak)
    return held


class RunFailed(Exception):
    """A multi-card run that ends without a line: ``code`` is the exit
    code, the message says which worker failed and how."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _device(platform: str, index: int) -> torch.device:
    return torch.device("cuda", index) if platform == "cuda" \
        else torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(conn, rank: int, n: int, port: int, bench: dict,
            cell_name: str, seed: int, seconds: float, trace: bool,
            platform: str, roots: list) -> None:
    """Worker ``rank`` of a multi-card run, in its own process: the
    environment ``torchrun`` gives, the cell's phases on its card, and
    its messages to the launcher: ``("set up", None)``, ``("freed",
    None)``, ``("line", (line, forbidden modules))``, or ``("error",
    traceback)``."""
    # the launcher's standard output carries only the result line
    sys.stdout.flush()
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank),
                       "WORLD_SIZE": str(n), "LOCAL_WORLD_SIZE": str(n),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})

    def meet(phase):
        conn.send((phase, None))
        if phase == "set up" or rank == 0:
            conn.recv()

    try:
        line = run_cell(bench, cell_name, seed, seconds, trace,
                        _device(platform, rank), roots=roots, meet=meet,
                        judge=rank == 0)
        conn.send(("line", (line, forbidden_modules())))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        conn.close()


def _gather(conns, procs, phase: str, wait_s: float) -> list:
    """Each worker's ``phase`` message, in rank order; raises
    :class:`RunFailed` when a worker reports an error, ends before it,
    or has not sent it within ``wait_s`` seconds."""
    got = [None] * len(conns)
    todo = set(range(len(conns)))
    deadline = time.monotonic() + wait_s
    while todo:
        ready = multiprocessing.connection.wait(
            [conns[r] for r in todo] + [procs[r].sentinel for r in todo],
            timeout=max(deadline - time.monotonic(), 0.0))
        if not ready:
            raise RunFailed(1, f"rank {min(todo)} did not reach {phase!r} "
                               f"within {wait_s:g} s: no reply")
        for r in sorted(todo):
            if not conns[r].poll():
                if procs[r].sentinel in ready:
                    raise RunFailed(1, f"rank {r} exited with code "
                                       f"{procs[r].exitcode} before "
                                       f"{phase!r}: no reply")
                continue
            try:
                what, info = conns[r].recv()
            except EOFError:
                procs[r].join(1.0)
                raise RunFailed(1, f"rank {r} exited with code "
                                   f"{procs[r].exitcode} before {phase!r}:"
                                   f" no reply") from None
            if what == "error":
                raise RunFailed(1, f"rank {r} failed:\n{info}")
            if what == phase:
                got[r] = info
                todo.discard(r)
    return got


def launch(bench: dict, cell_name: str, seed: int, seconds: float,
           trace: bool, n: int, platform: str = "cuda",
           roots=(HERE,)) -> dict:
    """One run of a cell on ``n`` cards, one worker process a card: the
    result line as a dict (see the module's docstring). Raises
    :class:`RunFailed` when a worker fails; every worker has ended when
    it returns or raises."""
    t_launch = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    conns, procs = [], []
    try:
        for r in range(n):
            here, there = ctx.Pipe()
            p = ctx.Process(target=_worker, name=f"ltrbench-rank{r}",
                            args=(there, r, n, port, bench, cell_name, seed,
                                  seconds, trace, platform, list(roots)))
            p.start()
            there.close()
            conns.append(here)
            procs.append(p)
        _gather(conns, procs, "set up",
                SETUP_WAIT_S - (time.perf_counter() - t_launch))
        setup_s = time.perf_counter() - T_START
        for c in conns:
            c.send("go")
        _gather(conns, procs, "freed", seconds + WINDOW_WAIT_S)
        conns[0].send("judge")
        done = _gather(conns, procs, "line", JUDGE_WAIT_S)
        for r, (_, bad) in enumerate(done):
            if bad:
                raise RunFailed(3, f"rank {r} loaded forbidden modules: "
                                   f"{', '.join(bad)}")
    finally:
        # a worker exits once it has sent its line; the rest are ended
        end = time.monotonic() + 10.0
        for p in procs:
            p.join(max(end - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for c in conns:
            c.close()
    return _merge([line for line, _ in done], setup_s)


def _merge(lines: list, setup_s: float) -> dict:
    """Rank 0's line with the launcher's ``setup_s``, the count of
    distinct cards on which some worker allocated memory, the fullest
    card's peak and ``by_rank``; the workers' ``cards`` and ``index``
    go into these."""
    line = lines[0]
    if "setup_s" in line["metrics"]:
        line["metrics"]["setup_s"]["value"] = float(setup_s)
    per_card = {}
    by_rank = []
    for r, ln in enumerate(lines):
        dev = ln["device"]
        for card, peak in dev.pop("cards").items():
            per_card[card] = max(per_card.get(card, 0), peak)
        by_rank.append({"rank": r, "index": dev.pop("index"),
                        **{k: dev[k] for k in ("memory_peak_bytes", "busy_s",
                                               "window_s") if k in dev}})
    dev = line["device"]
    dev["count"] = len(per_card)
    dev["memory_peak_bytes"] = int(max(per_card.values(), default=0))
    dev["by_rank"] = by_rank
    return line


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


def execute(bench: dict, args, roots=(HERE,), platform: str = "cuda") -> int:
    """Run the cell ``args.workload`` (one process on the first card, or
    :func:`launch` over ``chips`` cards), print the checks on standard
    error and the line last on standard output; the exit code."""
    n = int(find_cell(bench, args.workload)["chips"])
    try:
        if n == 1:
            line = run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), _device(platform, 0),
                            roots=roots)
        else:
            line = launch(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), n, platform, roots)
    except RunFailed as e:
        print(f"ltrbench: {e}", file=sys.stderr)
        return e.code
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
    return execute(bench, args)


if __name__ == "__main__":
    sys.exit(main())
