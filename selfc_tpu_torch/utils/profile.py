"""Profiling and cost accounting: the JAX package's ``utils/profile.py``.

  * ``count_params`` — the elements of a module's parameters or of a tree.
  * ``cost_analysis`` — the FLOPs of a call, counted by PyTorch's
    ``FlopCounterMode`` on the plain path.
  * ``StepTimer`` — an EMA step timer: CUDA events on the card, resolved
    only when read; the host clock on the CPU. ``EvalTimer``: an eval's
    seconds a clip, the host's and the device's.
  * ``trace`` — a context manager around ``torch.profiler`` that writes a
    chrome trace (``tools/profile_step.py`` splits it by kernel).
  * ``launch_counts`` — every kernel wrapper's launch counter, in one dict.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

TRACE_FILE = "trace.json"        # what ``trace`` writes into its logdir


def count_params(tree) -> int:
    """The number of parameter elements of an ``nn.Module``, or of a tree
    (dicts, lists, tuples) of numpy arrays, tensors or anything with a
    ``shape``: the JAX ``count_params`` of the same tree."""
    if isinstance(tree, torch.nn.Module):
        return int(sum(p.numel() for p in tree.parameters()))
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return int(np.prod(tree.shape))


def cost_analysis(fn, *args, **kwargs) -> dict:
    """``{'flops': n}`` of ``fn(*args, **kwargs)``, run once under
    ``torch.utils.flop_counter.FlopCounterMode``.

    The count is PyTorch's convention: the products alone (matmuls,
    convolutions, attention), 2 flops a multiply-add, every output position;
    biases, activations and other elementwise work count nothing. XLA's
    ``compiled.cost_analysis()`` also counts elementwise work and reports
    'bytes accessed', so the JAX number is not comparable with this one, and
    this count has no bytes.

    The hand-written kernels are ``ctypes`` calls the counter cannot see, so
    the call must take the plain path: a CUDA tensor among the arguments
    raises. The plain versions compute the same products. ``utils/bench.py``'s
    ``chain_cost`` / ``bound_ms`` are another count, the roofline model's:
    only the taps that land inside the clip, and the bytes the kernels move."""
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor) and a.is_cuda:
            raise ValueError("cost_analysis counts the plain path: pass CPU tensors "
                             "(the kernels' ctypes calls are invisible to the counter)")
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}


class StepTimer:
    """EMA step timer (the JAX ``StepTimer``'s ``tic`` / ``toc`` / ``avg``,
    ``avg = ema * avg + (1 - ema) * dt`` from the first ``dt``), in seconds.

    On a CUDA ``device`` ``tic`` / ``toc`` record a pair of timing events on
    the device's current stream and add no synchronisation: ``toc`` folds in
    the pairs that have completed (a query) and returns None, and ``read()``
    waits for the last pair (one ``synchronize``) and folds in the rest.
    Elsewhere they read ``time.perf_counter`` and ``toc`` returns ``dt``.
    ``clock`` names the clock, ``"cuda_event"`` or ``"host"``, so that a host
    time is never reported under a device's name. ``mean`` is the plain mean
    of the steps folded in."""

    def __init__(self, device=None, ema: float = 0.9):
        self.device = torch.device(device if device is not None else "cpu")
        self.clock = "cuda_event" if self.device.type == "cuda" else "host"
        self.ema = ema
        self.avg = None
        self.n = 0
        self.total = 0.0
        self._t0 = None
        self._pending = []

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def tic(self):
        self._t0 = self._event() if self.clock == "cuda_event" else time.perf_counter()

    def toc(self):
        if self.clock == "cuda_event":
            self._pending.append((self._t0, self._event()))
            self._fold(wait=False)
            return None
        dt = time.perf_counter() - self._t0
        self._add(dt)
        return dt

    def _add(self, dt):
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        self.n += 1
        self.total += dt

    def _fold(self, wait):
        if wait and self._pending:
            self._pending[-1][1].synchronize()
        while self._pending and self._pending[0][1].query():
            start, end = self._pending.pop(0)
            self._add(start.elapsed_time(end) / 1e3)

    def read(self):
        """The EMA after every step so far (on CUDA: after waiting for them)."""
        self._fold(wait=True)
        return self.avg

    @property
    def mean(self):
        self._fold(wait=True)
        return self.total / self.n if self.n else None


class EvalTimer:
    """Seconds a clip of an eval: ``host`` on the host's clock from
    ``start`` to ``copied`` (``test()`` and the copy of its visuals back),
    and on the card ``device``, ``test()``'s device time from ``start`` to
    ``tested`` (CUDA events)."""

    def __init__(self, device):
        self.host = StepTimer("cpu")
        self.device = StepTimer(device) if torch.device(device).type == "cuda" else None

    def start(self):
        self.host.tic()
        if self.device is not None:
            self.device.tic()

    def tested(self):
        if self.device is not None:
            self.device.toc()

    def copied(self):
        self.host.toc()

    def line(self) -> str:
        """``Timing over {n} clips: test_s: .. [gpu_test_s: ..]``, means a clip."""
        msg = "Timing over {:d} clips: test_s: {:.4e} ".format(self.host.n, self.host.mean or 0.0)
        if self.device is not None:
            msg += "gpu_test_s: {:.4e} ".format(self.device.mean or 0.0)
        return msg


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the body with ``torch.profiler`` (CPU and, on a CUDA
    ``device``, CUDA activities) and write its chrome trace to
    ``logdir/trace.json``. Yields the profiler, whose ``key_averages()`` the
    caller may read after the block. The profiler is stopped and the trace
    written on every way out of the block, an exception included; on CUDA the
    device is synchronised first, so the window holds the work it queued. The
    file is written under another name and renamed: where it exists it is
    whole."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device if device is not None else "cpu")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        try:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            prof.stop()
            path = os.path.join(logdir, TRACE_FILE)
            prof.export_chrome_trace(path + ".part")
            os.replace(path + ".part", path)


def launch_counts() -> dict:
    """Every kernel wrapper's calls so far, one counter a kind of call (a
    call makes one or more kernel launches: ``tools/profile_step.py:
    expected_events``): B1 the whole chain, B3 the spatial-only forward (B4's
    forward among them), B2 the chain adjoint (``B2_dx``: those that wrote a
    dx; B4's backward among them), B5 and B6 forward and backward
    (``B6_split``: calls with a split K), B7-B9 the chain variants."""
    from ..ops import chain_variants as cv, deform as df, dense_chain as dc, temporal_conv as tc

    return {"B1": dc.launches, "B3": dc.launches_feats, "B2": dc.launches_bwd, "B2_dx": dc.launches_bwd_dx,
            "B5": df.launches, "B5_bwd": df.launches_bwd, "B6": tc.launches, "B6_bwd": tc.launches_bwd,
            "B6_split": sum(n for (_, split), n in tc.launches_by_path.items() if split > 1),
            "B7": cv.launches_hg, "B8": cv.launches_v3, "B9": cv.launches_ride}
