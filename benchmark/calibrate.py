"""The readings the limits of ``correct`` are set from, on the card at the
cell's own size, many seeds in one process a rank:

    python3 -m benchmark.calibrate --workload NAME --seeds 1,2,3 [--control 4,5,6] \\
        [--faults 7,8,9 [--fault-kinds HalfBatch,NoExchange]] [--seconds 3]

Each seed runs the cell's driver for a short window and rank 0 prints one
JSON line ``{"mode", "seed", "checks", ...}``: ``program`` (the port),
``control`` (the driver's ``Control``: the plain reference in TF32 in the
program's place) or the name of a planted fault (the driver's ``FAULTS``;
on several ranks also its ``RANK_FAULTS``). A cell on several cards runs a process a card,
as ``benchmark.run`` does. Limits are not applied here."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import torch

from benchmark import harness
from benchmark.run import RANK_VAR, cell_entry, start_ranks, stop_ranks


def readings(name, seed, seconds, rank, world, make_program=None):
    device = torch.device("cuda", torch.cuda.current_device())
    r = harness.Run(name, seed, seconds, False, device, rank, world, make_program=make_program)
    driver = importlib.import_module(f"benchmark.drivers.{r.cell['driver']}")
    t = time.perf_counter()
    res = driver.run(r)
    return {"checks": res.get("checks"), "e2e": res.get("e2e"), "setup_s": r.setup_s,
            "run_s": time.perf_counter() - t, "memory_peak_bytes": res["memory_peak_bytes"]}


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Readings of the numbers correct compares.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-kinds", default="", help="the planted faults to run (default: every one the cell can have)")
    ap.add_argument("--seconds", type=float, default=3.0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    rank = int(os.environ.get(RANK_VAR, "0"))
    world = int(cell_entry(args.workload)[0]["chips"])
    harness.require_cards(world)
    kind = harness.load_json("workloads", f"{args.workload}.json")["driver"]
    procs = []
    if world > 1:
        if rank == 0:
            from selfc_tpu_torch.kernels import build

            build.build()
            procs = start_ranks(args, world, module="benchmark.calibrate", argv=sys.argv[1:])
        from selfc_tpu_torch.parallel.dist import init_distributed

        init_distributed("cuda")

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    driver = importlib.import_module(f"benchmark.drivers.{kind}")
    program = driver.program
    plan = [("program", s, None) for s in seeds(args.seeds)]
    plan += [("control", s, driver.Control) for s in seeds(args.control)]
    faults = driver.FAULTS + (getattr(driver, "RANK_FAULTS", ()) if world > 1 else ())
    if args.fault_kinds:
        faults = [f for f in faults if f.__name__ in args.fault_kinds.split(",")]
    for fault in faults:
        plan += [(fault.__name__, s, lambda run, tree, f=fault: f(program(run, tree))) for s in seeds(args.faults)]
    try:
        for mode, seed, make in plan:
            out = readings(args.workload, seed, args.seconds, rank, world, make)
            if rank == 0:
                print(json.dumps({"mode": mode, "seed": seed, **out}), flush=True)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
        if procs:
            stop_ranks(procs)


if __name__ == "__main__":
    main()
