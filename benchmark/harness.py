"""What every driver shares: the run's context (the cell, its configuration,
traffic mix and limits, the seed, the window, the configuration's plain
reference and work model), the card checks, the weights made on the card
from the seed, the profiler window, the card's readings from
``nvidia-smi`` and the lines the run prints."""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .traffic import generate
from .yardstick import trace as trace_split

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "selfc_tpu")   # compared as whole top-level names


class CardMissing(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


def load_json(*parts):
    with open(BENCH_DIR.joinpath(*parts)) as f:
        return json.load(f)


def sub_seed(seed, *tags):
    """A 63-bit seed drawn from the run's seed and the integer ``tags``."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, *tags]).generate_state(1, np.uint64)[0]) >> 1


def banned_modules():
    """The top-level names among ``sys.modules`` that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Run:
    """One run of one cell. ``cell``: the cell's file under ``workloads/``;
    ``cfg``, ``mix``: its configuration and traffic files; ``limits``: the
    numbers ``correct`` holds the outputs to; ``ref``, ``work_model``: the
    modules the configuration names (``reference/<reference>.py``, the
    net's plain reference with its ``param_shapes`` and ``init_std``, and
    ``yardstick/<work_model>.py``, its chain calls and products).
    ``make_program`` builds the system under test (a test may hand in
    another). ``rank`` / ``world``: this process among the cell's ranks."""

    def __init__(self, name, seed, seconds, trace, device, rank=0, world=1, make_program=None,
                 t_start=None):
        self.name = name
        self.cell = load_json("workloads", f"{name}.json")
        self.cfg = load_json("configs", f"{self.cell['config']}.json")
        self.mix = load_json("traffic", "mixes", f"{self.cell['traffic']}.json")
        generate.check_mix(self.mix)
        self.limits = self.cell["limits"]
        self.ref = importlib.import_module(f"{__package__}.reference.{self.cfg['reference']}")
        self.work_model = importlib.import_module(f"{__package__}.yardstick.{self.cfg['work_model']}")
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.rank, self.world = rank, world
        self.make_program = make_program
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.setup_s = None
        self.marks = {}

    def mark(self, what):
        """Note the seconds since the run began at a step of its set-up."""
        self.marks[what] = time.perf_counter() - self.t_start

    def info(self, **kw):
        """A line of what the run saw, printed before the result (rank 0)."""
        if self.rank == 0:
            print(json.dumps({"info": kw}, default=float), flush=True)

    def window_open(self):
        """Set-up ends here: everything before it counts as ``setup_s``."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        return time.perf_counter()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self):
        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def weights(self):
        """The net's parameters made from the seed on the run's device: one
        ``randn`` of every leaf's elements from a generator on the device,
        split and scaled leaf by leaf (the reference's ``param_shapes`` and
        ``init_std``). ``{name: tensor}``."""
        shapes = self.ref.param_shapes(self.cfg)
        total = sum(int(np.prod(s)) for s in shapes.values())
        g = torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, 1))
        flat = torch.randn(total, generator=g, device=self.device)
        tree, at = {}, 0
        for name, shape in shapes.items():
            n = int(np.prod(shape))
            tree[name] = flat[at:at + n].view(shape) * self.ref.init_std(name, shape)
            at += n
        return tree


@contextlib.contextmanager
def traced(run):
    """Profile the body (host and card) and yield a dict that holds
    ``start_s``, the seconds the profiler took to start, and after the
    block ``attr``: the trace split over the body's window
    (``yardstick.trace.attribute``). The trace is written under ``TMPDIR``
    and removed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda" else [])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        prof = profile(activities=acts)
        t = time.perf_counter()
        prof.start()
        out["start_s"] = time.perf_counter() - t
        try:
            with record_function("bench.window"):
                yield out
                run.sync()
        finally:
            prof.stop()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        evs = trace_split.events(path)
        win = [e for e in evs if e.get("name") == "bench.window" and e.get("cat") == "user_annotation"]
        window = (win[0]["ts"], win[0]["ts"] + win[0]["dur"]) if win else None
        out["attr"] = trace_split.attribute(evs, window)


def closed_loop(r, request, start, picks, n_traced):
    """One client's closed loop over ``request(j)``, j counting from
    ``start``: without ``--trace`` until ``seconds`` have passed (the last
    request that starts before then runs to its end); with it
    ``n_traced`` requests without the profiler, then as many under it.
    Keeps the results of the requests ``picks`` (counted from the first
    kept one) and of the last. Returns ``{"lat", "kept", "t0", "t_last"}``,
    traced also ``attr``, ``units``, ``wall_s`` (the untraced requests)
    and ``traced_wall_s``."""
    from torch.profiler import record_function

    out = {"lat": [], "kept": {}}

    def loop(base, n_units, t_end, keep):
        i = res = 0
        while (i < n_units) if n_units else time.perf_counter() < t_end:
            ts = time.perf_counter()
            with record_function("bench.request"):
                res = request(base + i)
            out["lat"].append(time.perf_counter() - ts)
            if keep and i in picks:
                out["kept"][base + i] = res
            i += 1
        if keep:
            out["kept"][base + i - 1] = res
        return base + i, time.perf_counter()

    out["t0"] = t0 = r.window_open()
    if r.trace:
        base, t1 = loop(start, n_traced, None, False)
        with traced(r) as tr:
            _, out["t_last"] = loop(base, n_traced, None, True)
        out.update(attr=tr["attr"], units=n_traced, wall_s=t1 - t0,
                   traced_wall_s=out["t_last"] - t1 - tr["start_s"])
    else:
        _, out["t_last"] = loop(start, None, t0 + r.seconds, True)
    return out


def smi():
    """The card's name, power limit and draw, SM clock and temperature, as
    ``nvidia-smi`` reads them (one dict a card), or None without it."""
    fields = "name,power.limit,power.draw,clocks.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return [dict(zip(fields.split(","), (v.strip() for v in line.split(",")))) for line in out.strip().splitlines()]


def require_cards(n):
    if not torch.cuda.is_available():
        raise CardMissing("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise CardMissing(f"the cell needs {n} cards, torch sees {torch.cuda.device_count()}")
