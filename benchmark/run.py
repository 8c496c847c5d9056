"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the cards the cell asks for.
The cell's file (``benchmark/workloads/NAME.json``) names its driver
(``benchmark/drivers/<driver>.py``: the path, its unit's work, its control
and faults), its configuration (``benchmark/configs/``, which names the
net's plain reference and work model), its traffic mix
(``benchmark/traffic/mixes/``) and the limits ``correct`` holds its
outputs to; ``BENCHMARK.json`` names the metrics it reports. ``--trace 0`` measures the window and prints the
cell's end-to-end metrics; ``--trace 1`` profiles a whole number of units
instead and prints its per-layer metrics, each read by
``benchmark/metrics/<family>.py`` (the family is the name before its first
dot). A cell on several cards runs one rank a card: this process is rank
0 and starts the others.

The last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit); the checks are
also the last lines of standard error. Without the cards, with ``jax`` or
the JAX package loaded, or on a failure, the run exits non-zero and prints
no result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

RANK_VAR = "SELFC_BENCH_RANK"


def parse(argv=None):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_entry(name):
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")

    def mine(m):
        return name in m.get("workloads", wl)

    return wl[name], [m for m in bench["end_to_end"] if mine(m)], [m for m in bench["per_layer"] if mine(m)]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(args, world, module="benchmark.run", argv=None):
    """Ranks 1..world-1 of the cell, each ``module`` in a process of its
    own on its card (with ``argv``, else this run's arguments); this process
    becomes rank 0."""
    port = str(free_port())
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=str(world), RANK="0", LOCAL_RANK="0")
    procs = []
    for rank in range(1, world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), **{RANK_VAR: str(rank)})
        cmd = [sys.executable, "-m", module] + (argv if argv is not None else [
            "--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
            "--trace", str(args.trace)])
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL))
    return procs


def stop_ranks(procs, timeout=120):
    """Wait for every other rank; end those that outlive ``timeout``."""
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def per_layer(metrics, ctx):
    """Each per-layer metric the cell reports, read by its family's reader;
    a reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        reader = importlib.import_module(f"benchmark.metrics.{m['name'].split('.')[0]}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def gather_trace(r, res):
    """Rank 0's view of the traced window: its own split and every rank's
    (``attrs``)."""
    attrs = [res["attr"]]
    if r.world > 1:
        import torch.distributed as dist

        attrs = [None] * r.world
        dist.all_gather_object(attrs, res["attr"])
    return {"attr": res["attr"], "attrs": attrs, "units": res["units"], "wall_s": res["wall_s"],
            "traced_wall_s": res["traced_wall_s"], "work": res["work"], "world": r.world,
            "data_wait_s": res.get("data_wait_s")}


def main(argv=None):
    args = parse(argv)
    rank = int(os.environ.get(RANK_VAR, "0"))
    entry, e2e, layers = cell_entry(args.workload)
    world = int(entry["chips"])
    importlib.import_module("selfc_tpu_torch")     # the system under test: raises where it is missing
    harness.require_cards(world)
    procs = []
    if world > 1 and rank == 0:
        from selfc_tpu_torch.kernels import build

        build.build()                      # once, before the other ranks load the libraries
        procs = start_ranks(args, world)
    try:
        if world > 1:
            from selfc_tpu_torch.parallel.dist import init_distributed

            init_distributed("cuda")
        device = torch.device("cuda", torch.cuda.current_device())
        r = harness.Run(args.workload, args.seed, args.seconds, args.trace, device, rank, world, t_start=T_START)
        r.mark("start")
        driver = importlib.import_module(f"benchmark.drivers.{r.cell['driver']}")
        res = driver.run(r)
        card = harness.smi() if rank == 0 else None      # the card's clocks and power as the window closed
        peaks = [res["memory_peak_bytes"]]
        traced = gather_trace(r, res) if args.trace else None
        if world > 1:
            import torch.distributed as dist

            peaks = [None] * world
            dist.all_gather_object(peaks, res["memory_peak_bytes"])
            dist.barrier()
            dist.destroy_process_group()
        if rank:
            return 0
        banned = harness.banned_modules()
        if banned:
            print(f"the run loaded {banned}: the benchmark may not hold jax, flax or the JAX package",
                  file=sys.stderr)
            return 3
        codes = stop_ranks(procs)
        procs = []
        if any(codes):
            print(f"a rank failed: exit codes {codes}", file=sys.stderr)
            return 4
        return report(r, res, e2e, layers, traced, max(peaks), card)
    finally:
        if procs:
            for p in procs:
                p.kill()
            stop_ranks(procs, 10)


def report(r, res, e2e, layers, traced, peak, card):
    limits = r.limits
    checks = {k: {"value": v, "limit": limits[k]} for k, v in res["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if traced is None:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                   for m in e2e if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": r.setup_s, "unit": "s"}
    else:
        metrics = per_layer(layers, traced)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(r.device), "count": r.world,
              "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
            "device": device}
    if traced is not None:
        attrs = traced["attrs"]
        device["busy_s"] = sum(a["busy_s"] for a in attrs) / len(attrs)
        device["window_s"] = traced["attr"]["window_s"]
        line["breakdown"] = {"device_ops": [list(op) for op in traced["attr"]["ops"]],
                             "idle_gaps": traced["attr"]["gaps"]}
        r.info(buckets_s=traced["attr"]["buckets"], traced_units=traced["units"], untraced_wall_s=traced["wall_s"],
               traced_wall_s=traced["traced_wall_s"])
    r.info(setup_s=r.setup_s, setup_marks=r.marks, card=card)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except harness.CardMissing as e:
        print(e, file=sys.stderr)
        sys.exit(2)
