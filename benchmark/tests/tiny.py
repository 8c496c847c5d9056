"""Cells cut to a size the CPU runs in seconds (the nets keep their kinds
of blocks; depth, frames and batch shrink), for the benchmark's tests."""

from __future__ import annotations

import json

from benchmark import harness

SEED = 2 ** 31 + 7


def tiny_run(name, trace=False, seed=SEED, device="cpu", seconds=0.5):
    r = harness.Run(name, seed, seconds, trace, device)
    net, m = r.cfg["network_G"], r.mix
    net.update(block_num=[1, 1] if r.cfg["model"] == "SelfC_GMM" else [1], stp_blk_num=3)
    if m["kind"] == "clip_pool" and r.cfg["model"] == "SelfC_GMM":
        m.update(clips=3, height=32, width=48, traced_units=2, warmup=1)
    elif m["kind"] == "clip_pool":
        m.update(clips=2, height=32, width=64, traced_units=2, warmup=1)
        r.cfg["video_len"] = 6
    else:
        m.update(clips=4, height=40, width=48, traced_units=2, eps_pool=2)
        r.cfg["datasets"]["train"].update(video_len=3, GT_size=16, batch_size=2)
    return r


def correct(r, res):
    """``correct`` as the run decides it: every number within its limit."""
    return all(v <= r.limits[k] for k, v in res["checks"].items())


def bench():
    with open(harness.ROOT / "BENCHMARK.json") as f:
        return json.load(f)
