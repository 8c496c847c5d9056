"""A ``torch.profiler`` chrome trace split by kernel: a frozen copy of the
port's trace split, with a ``collective`` bucket (NCCL's kernels) and a
``copy`` bucket (the device's memory copies and sets).

Buckets, read off the kernels' demangled names:
  * ``B1/B3``: ``chain_layer_kernel`` (no variant flag) and
    ``chain_conv5_kernel``: the whole-chain forward and its spatial-only entry;
  * ``B2``: the chain adjoint (``dacc_kernel``, ``weight_grad_kernel``,
    ``data_grad_kernel``, ``reduce_partials_kernel`` after one of them);
  * ``B5``-``B9``: the deformable conv, the temporal conv and the chain
    variants (H/G pair, v3, ride);
  * ``collective``: NCCL;  ``library``: cuDNN, cuBLAS, CUTLASS;
  * ``copy``: memory copies and sets;  ``other``: every other kernel.
"""

from __future__ import annotations

import json
import os
import re

BUCKETS = ("B1/B3", "B2", "B5", "B6", "B7", "B8", "B9", "collective", "library", "copy", "other")
CHAIN_FWD = ("B1/B3", "B7", "B8", "B9")       # the chain forward, whichever kernel computes it
CHAIN_BWD = ("B2",)
_BY_SYMBOL = {"chain_conv5_kernel": "B1/B3", "dacc_kernel": "B2", "weight_grad_kernel": "B2",
              "data_grad_kernel": "B2", "bound_kernel": "B5", "dx_convert_kernel": "B5",
              "temporal_conv3_kernel": "B6", "split_reduce_kernel": "B6", "hg_conv5_kernel": "B7",
              "v3_conv5_kernel": "B8", "ride_finish_kernel": "B9"}
_LIBRARY = re.compile(r"cudnn|cublas|cutlass|xmma|gemm|gemv|convolve|winograd|fft|nchwToNhwc|nhwcToNchw"
                      r"|dgrad|wgrad|splitKreduce", re.IGNORECASE)
_NCCL = re.compile(r"nccl", re.IGNORECASE)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def _symbol(name):
    """``(symbol, template arguments)`` of a demangled kernel name."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)::", "")
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


def bucket_of(name, previous=None, cat="kernel"):
    """The bucket of one device event; ``previous`` is the bucket of the
    kernel before it on its stream (B5's reduction follows B5's backward)."""
    if cat != "kernel":
        return "copy"
    if _NCCL.search(name):
        return "collective"
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
    if not name.startswith("at::") and _LIBRARY.search(name):
        return "library"
    return "other"


def events(trace):
    """The complete events of a chrome trace (a path, a parsed dict or a
    list)."""
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def attribute(trace, window=None, n_ops=10, n_gaps=10) -> dict:
    """Split a trace's device time (seconds). ``window``: ``(t0, t1)`` in
    the trace's microseconds (default: the span of every event). Returns
    ``window_s``, ``busy_s`` (the union of the device events' intervals
    inside the window), ``idle_share``, ``buckets`` ({bucket: seconds of
    its events}), ``ops`` (the ``n_ops`` kernels by summed time, named
    ``bucket: symbol``) and ``gaps`` (the ``n_gaps`` longest idle stretches,
    each named by the host operation that overlaps it most)."""
    evs = events(trace)
    if window is None:
        window = (min(e["ts"] for e in evs), max(e["ts"] + e["dur"] for e in evs)) if evs else (0.0, 0.0)
    t0, t1 = window
    dev = sorted((e for e in evs if str(e.get("cat", "")).lower() in DEVICE_CATS
                  and e["ts"] < t1 and e["ts"] + e["dur"] > t0), key=lambda e: e["ts"])
    buckets = {b: 0.0 for b in BUCKETS}
    ops, last_on, spans = {}, {}, []
    for e in dev:
        s, f = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        stream = (e.get("pid"), e.get("tid"))
        cat = str(e.get("cat", "")).lower()
        b = bucket_of(e["name"], last_on.get(stream), cat)
        if cat == "kernel":
            last_on[stream] = b
        buckets[b] += (f - s) / 1e6
        key = f"{b}: {_symbol(e['name'])[0] if cat == 'kernel' else e['name']}"
        ops[key] = ops.get(key, 0.0) + (f - s) / 1e6
        spans.append((s, f))
    busy = union(spans)
    busy_us = sum(f - s for s, f in busy)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = [e for e in evs if e.get("cat") in HOST_CATS and e["name"] != "bench.window"]
    gaps = []
    for s, f in sorted(idle, key=lambda iv: iv[0] - iv[1])[:n_gaps]:
        # the host op that covers most of the gap, the innermost among equals
        best, best_key = "no host op", (0.0, 0.0)
        for h in host:
            ov = min(f, h["ts"] + h["dur"]) - max(s, h["ts"])
            if ov > 0 and (ov, -h["dur"]) > best_key:
                best, best_key = h["name"], (ov, -h["dur"])
        gaps.append([best, (f - s) / 1e6])
    window_s = (t1 - t0) / 1e6
    return {"window_s": window_s, "busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / (t1 - t0) if t1 > t0 else None,
            "buckets": buckets, "ops": sorted(ops.items(), key=lambda kv: -kv[1])[:n_ops],
            "gaps": gaps}
