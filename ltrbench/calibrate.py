"""Readings for the limits that decide ``correct``, at a cell's own size,
many seeds in one process (the benchmark's own runs never run this):

* ``program``: the program's set-up and a window of ``--window``
  seconds, judged as a run judges it (the lower readings);
* ``control``: the reference in the program's place, computed in
  bfloat16 (the precision below the configurations' float32), judged
  the same way (upper readings);
* each fault of ``ltrbench.faults``, planted in the program.

    python3 -m ltrbench.calibrate --workload lambdamart.mslr30k \\
        --seeds 11,12,13 --upper 3 --window 5 --out readings.jsonl

The control and the faults run on the first ``--upper`` seeds;
``--modes`` keeps some of them (``--modes nan`` reads one fault alone).
Each reading is printed as one JSON line, and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from ltrbench import gen, run
from ltrbench.faults import FAULTS, fault
from ltrbench.reference.judge import Context


def readings(cell_name: str, seeds: list, upper: int, window: float,
             device, modes=("program", "control", *FAULTS)):
    """Yield {"cell", "seed", "mode", "nums", "seconds"} for every
    reading."""
    roots = (run.HERE,)
    cell = run.find_cell(run.load_bench(), cell_name)
    cfg = run.load_json(roots, "configs", cell["config"])
    traffic = run.load_json(roots, "traffic", cell["traffic"])
    driver = run.load_driver(roots, cfg["driver"])
    if device.type == "cuda":
        from ranklib_tpu_torch.ops._build import build_all

        build_all()
    for i, seed in enumerate(seeds):
        train, vali = gen.generate(traffic, seed, device,
                                   with_validation=bool(cfg.get("validation")))
        ctx = Context(train, vali, int(cfg["params"]["n_threshold"]), device)
        for mode in modes:
            if mode != "program" and i >= upper:
                continue
            t0 = time.perf_counter()
            if mode == "control":
                outs = driver.control(ctx, cfg, seed, torch.bfloat16)
            else:
                with (fault(cfg["driver"], mode) if mode != "program"
                      else contextlib.nullcontext()):
                    sut = driver.Driver(cfg, train, vali, device)
                    if window > 0 and mode == "program":
                        sut.window(window)
                    outs = sut.outputs()
                    sut.close()
                    del sut
            if device.type == "cuda":
                torch.cuda.empty_cache()
            nums = driver.judge(ctx, outs, cfg, seed)
            yield {"cell": cell_name, "seed": seed, "mode": mode,
                   "nums": nums, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ltrbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--upper", type=int, default=3,
                   help="seeds (the first ones) that also run the control "
                        "and the faults")
    p.add_argument("--window", type=float, default=0.0)
    p.add_argument("--modes", default=",".join(("program", "control",
                                                 *FAULTS)),
                   help="comma-separated: program, control, faults")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ltrbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workload, seeds, args.upper, args.window,
                          torch.device("cuda", 0),
                          tuple(args.modes.split(","))):
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
