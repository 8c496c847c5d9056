"""A ``torch.profiler`` chrome trace split by kernel: the port's counterpart
of the root ``tools/profile_step.py`` / ``profile_roundtrip.py``::

    python -m selfc_tpu_torch.tools.profile_step DIR

``DIR`` is what ``utils/profile.py:trace`` wrote (``trace.json``; with
``cli.train --profile-at`` also ``launches.json``, the kernel wrappers'
calls over the same steps). Prints one JSON object: ``attribute``'s split
and, with ``launches.json``, each bucket's kernel events beside the number
the wrappers' calls make.

The buckets are read off the kernels' symbol names (their template
arguments where one kernel serves several TPU kernels):
  * ``B1/B3``: ``chain_layer_kernel<T, Tile, GCP, STRIPE, 0, false, false>``
    and ``chain_conv5_kernel`` (the whole chain and its spatial-only entry;
    B4's forward is B3's entry);
  * ``B2``: ``dacc_kernel``, ``weight_grad_kernel``, ``reduce_partials_kernel``,
    ``data_grad_kernel``;
  * ``B5``: ``deform_*``, ``bound_kernel``, ``dx_convert_kernel`` and the
    ``reduce_partials_kernel`` that follows ``deform_backward_kernel`` on its
    stream;
  * ``B6``: ``temporal_conv3_kernel``, ``split_reduce_kernel``;
  * ``B7``: ``hg_conv5_kernel`` and ``chain_layer_kernel`` with ``PAIR``;
  * ``B8``: ``v3_conv5_kernel`` and ``chain_layer_kernel`` with ``TRUE_WIDTH``;
  * ``B9``: ``ride_finish_kernel`` and ``chain_layer_kernel`` with ``NR > 0``;
  * ``library``: cuDNN and cuBLAS (and the CUTLASS / xmma kernels they run);
  * ``other``: every other kernel (PyTorch's own).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path

BUCKETS = ("B1/B3", "B2", "B5", "B6", "B7", "B8", "B9", "library", "other")
# {launch counter: (its bucket, kernels a call makes)}: B1 four spatial layers
# and conv5, B3 the four layers, B2 dacc, four weight gradients, four
# reductions and three data gradients (a fourth with dx), B5's backward four,
# B6 one (two with a split K), B7-B9 four layers and a finishing kernel
KERNELS_A_CALL = {"B1": ("B1/B3", 5), "B3": ("B1/B3", 4), "B2": ("B2", 12), "B2_dx": ("B2", 1), "B5": ("B5", 1),
                  "B5_bwd": ("B5", 4), "B6": ("B6", 1), "B6_bwd": ("B6", 1), "B6_split": ("B6", 1),
                  "B7": ("B7", 5), "B8": ("B8", 5), "B9": ("B9", 5)}
_BY_SYMBOL = {"chain_conv5_kernel": "B1/B3", "dacc_kernel": "B2", "weight_grad_kernel": "B2",
              "data_grad_kernel": "B2", "bound_kernel": "B5", "dx_convert_kernel": "B5",
              "temporal_conv3_kernel": "B6", "split_reduce_kernel": "B6", "hg_conv5_kernel": "B7",
              "v3_conv5_kernel": "B8", "ride_finish_kernel": "B9"}
_LIBRARY = re.compile(r"cudnn|cublas|cutlass|xmma|gemm|gemv|convolve|winograd|fft|nchwToNhwc|nhwcToNchw"
                      r"|dgrad|wgrad|splitKreduce", re.IGNORECASE)
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
N_GAPS = 5


def package_kernels() -> set:
    """The ``__global__`` functions of ``selfc_tpu_torch/csrc``: the symbols
    a kernel of this package can have."""
    csrc = Path(__file__).resolve().parents[1] / "csrc"
    return {m for f in sorted(csrc.glob("*.cu*")) for m in _GLOBAL.findall(f.read_text())}


def _unvoid(name):
    return name[5:] if name.startswith("void ") else name


def _symbol(name):
    """``(symbol, template arguments)`` of a demangled kernel name."""
    head = _unvoid(name).replace("(anonymous namespace)::", "")
    cut = min((i for i in (head.find("<"), head.find("(")) if i >= 0), default=len(head))
    symbol = head[:cut].split("::")[-1].strip()
    args = []
    if cut < len(head) and head[cut] == "<":
        depth, at = 0, cut + 1
        for i in range(cut, len(head)):
            c = head[i]
            if c in "<(":
                depth += 1
            elif c in ">)":
                depth -= 1
                if depth == 0:
                    args.append(head[at:i].strip())
                    break
            elif c == "," and depth == 1:
                args.append(head[at:i].strip())
                at = i + 1
    return symbol, args


def _true(arg):
    return arg in ("true", "1", "(bool)1")


def bucket_of(name, previous=None):
    """The bucket of one kernel name; ``previous`` is the bucket of the
    kernel before it on its stream (it tells B5's ``reduce_partials_kernel``
    from B2's)."""
    symbol, args = _symbol(name)
    if symbol == "chain_layer_kernel":
        if len(args) >= 7 and _true(args[6]):
            return "B7"
        if len(args) >= 6 and _true(args[5]):
            return "B8"
        if len(args) >= 5 and args[4] not in ("0", "(int)0"):
            return "B9"
        return "B1/B3"
    if symbol == "reduce_partials_kernel":
        return "B5" if previous == "B5" else "B2"
    if symbol.startswith("deform_"):
        return "B5"
    if symbol in _BY_SYMBOL:
        return _BY_SYMBOL[symbol]
    if not _unvoid(name).startswith("at::") and _LIBRARY.search(name):
        return "library"
    return "other"


def _events(trace):
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def attribute(trace) -> dict:
    """Split a chrome trace's device time into ``BUCKETS`` (times in ms).

    ``trace``: the path of a chrome trace, its parsed dict or its event list.
    Returns the window (the span of every complete event), the device's busy
    time (the union of the kernel intervals) and idle share of the window,
    each bucket's summed kernel time, share of the summed time and kernel
    events, the ``N_GAPS`` longest idle gaps with the host ops that overlap
    each most, and ``unattributed``: the names of kernels of this package
    (``package_kernels``) that no B bucket took."""
    events = _events(trace)
    kernels = sorted((e for e in events if str(e.get("cat", "")).lower() == "kernel"), key=lambda e: e["ts"])
    out = {"device_events": len(kernels), "buckets": {b: {"ms": 0.0, "events": 0} for b in BUCKETS}}
    if not events:
        return {**out, "window_ms": 0.0, "busy_ms": 0.0, "idle_share": None, "gaps": [], "unattributed": []}
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    last_on = {}
    ours, unattributed = package_kernels(), set()
    for k in kernels:
        stream = (k.get("pid"), k.get("tid"), (k.get("args") or {}).get("stream"))
        b = bucket_of(k["name"], last_on.get(stream))
        last_on[stream] = b
        out["buckets"][b]["ms"] += k["dur"] / 1e3
        out["buckets"][b]["events"] += 1
        if b in ("library", "other") and _symbol(k["name"])[0] in ours:
            unattributed.add(k["name"])
    busy = _union((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    busy_us = sum(e - s for s, e in busy)
    total = sum(v["ms"] for v in out["buckets"].values())
    for v in out["buckets"].values():
        v["share"] = v["ms"] / total if total > 0 else 0.0
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    gaps = []
    for s, e in sorted(idle, key=lambda iv: iv[0] - iv[1])[:N_GAPS]:
        overlap = {}
        for h in host:
            ov = min(e, h["ts"] + h["dur"]) - max(s, h["ts"])
            if ov > 0:
                overlap[h["name"]] = max(overlap.get(h["name"], 0.0), ov)
        top = sorted(overlap.items(), key=lambda kv: -kv[1])[:3]
        gaps.append({"start_ms": (s - t0) / 1e3, "ms": (e - s) / 1e3,
                     "host_ops": [[n, ov / 1e3] for n, ov in top]})
    window = (t1 - t0) / 1e3
    return {**out, "window_ms": window, "busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / window if window > 0 else None,
            "gaps": gaps, "unattributed": sorted(unattributed)}


def expected_events(counts) -> dict:
    """Kernel events a bucket should hold for the wrappers' calls ``counts``
    (``utils/profile.py:launch_counts``, or a difference of two)."""
    out = {}
    for key, n in counts.items():
        if key in KERNELS_A_CALL:
            b, k = KERNELS_A_CALL[key]
            out[b] = out.get(b, 0) + k * int(n)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Split a torch.profiler trace by kernel.")
    ap.add_argument("dir", help="the directory utils/profile.py:trace wrote")
    args = ap.parse_args(argv)
    from ..utils.profile import TRACE_FILE

    out = attribute(os.path.join(args.dir, TRACE_FILE))
    launches = os.path.join(args.dir, "launches.json")
    if os.path.exists(launches):
        with open(launches) as f:
            window = json.load(f)
        want = expected_events(window["counts"])
        out["launches"] = window
        out["events_vs_launches"] = {b: [out["buckets"][b]["events"], n] for b, n in want.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
