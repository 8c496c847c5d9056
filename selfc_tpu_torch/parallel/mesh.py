"""The device mesh: the port's counterpart of the JAX package's
``parallel/mesh.py`` (``make_mesh``, ``dp_sharding``, the ``(dp, sp)``
batch sharding).

The JAX package names a ``(dp, sp)`` grid of devices and lets XLA place
every array on it: the batch over ``dp``, the image width over ``sp``, with
the convolutions' halo exchanges and the gradients' sums inserted by the
compiler. PyTorch has no such compiler, so the port says each move itself:

* ``make_mesh`` builds the grid of explicit ``torch.device``s (a device may
  repeat: ``["cpu", "cpu"]`` runs the split logic on the CPU, ``cuda:0``
  twice on a one-card machine);
* ``dp_split`` / ``dp_gather`` cut an axis-0 batch into one part a device
  and put it back in order;
* ``shard_w`` / ``gather_w`` cut the W axis (channels-last, axis -2) into
  equal shards; ``halo_w`` gives each shard ``h`` columns of each neighbour
  (none at the image's true edges) and ``unhalo_w`` crops them off again;
* ``Replicas`` holds each device's copy of a module's parameters and runs
  the module there through ``torch.func.functional_call``. Under autograd
  the copies are ``.to(device)`` of the master parameters, so the gradients
  of every device's work sum into the masters: the JAX package's psum.

Every move is a ``.to(device)``, and ``torch.cat`` of its results: autograd
carries the gradient back along each, so a halo's gradient lands in the
neighbour's columns it was copied from.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn

W_AXIS = -2   # channels-last (..., H, W, C)


def _device(d) -> torch.device:
    """``d`` as a torch.device with its index: ``cuda`` alone is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ``(dp, sp)`` grid of devices: ``devices[r][c]`` holds row r's
    shard c. Rows take parts of the batch, the columns of a row the width."""

    def __init__(self, grid):
        self.devices = [[_device(d) for d in row] for row in grid]
        self.dp, self.sp = len(self.devices), len(self.devices[0])
        if any(len(row) != self.sp for row in self.devices):
            raise ValueError(f"mesh rows of unequal length: {grid}")

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def master(self) -> torch.device:
        """The device that holds the master parameters and the gathered results."""
        return self.devices[0][0]

    def cards(self) -> int:
        """The number of distinct devices in the grid."""
        return len({str(d) for row in self.devices for d in row})

    def __repr__(self):
        return f"Mesh(dp={self.dp}, sp={self.sp}, devices={[[str(d) for d in r] for r in self.devices]})"


def process_cards(sp: int = 1) -> list[torch.device]:
    """The cards this process owns: every card it sees, or under ``torchrun``
    (``WORLD_SIZE`` > 1) the ``sp`` cards from ``LOCAL_RANK * sp``. Raises
    without a CUDA device or where the cards run out."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices (e.g. ['cpu', 'cpu'] "
                           "repeats the CPU)")
    n = torch.cuda.device_count()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        first = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0"))) * sp
        if first + sp > n:
            raise RuntimeError(f"make_mesh: local rank's cards {first}..{first + sp - 1}, "
                               f"but this process sees {n}")
        return [torch.device("cuda", first + i) for i in range(sp)]
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(dp: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """The ``(dp, sp)`` grid over ``devices`` (default: ``process_cards(sp)``);
    ``dp`` defaults to their number over ``sp``. Raises where ``dp * sp`` is
    not their number, as the JAX ``make_mesh`` does."""
    devices = list(devices) if devices is not None else process_cards(sp)
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp < 1 or sp < 1 or dp * sp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) != device count ({n})")
    return Mesh([devices[r * sp:(r + 1) * sp] for r in range(dp)])


def model_mesh(device, sp: int = 1) -> Mesh:
    """The mesh a model wrapper builds for ``device`` when given none: on a
    CUDA device named without an index, ``make_mesh(sp=sp)`` over the
    process's cards; on one named device (an indexed card, the CPU), that
    device alone, repeated ``sp`` times on the CPU only (a card named alone
    with ``sp`` > 1 raises: it is one card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return make_mesh(sp=sp)
    return make_mesh(dp=1, sp=sp, devices=[device] * (sp if device.type == "cpu" else 1))


# ---------------------------------------------------------------------------
# axis 0: data parallel
# ---------------------------------------------------------------------------


def dp_split(x, devices):
    """Axis 0 of ``x`` in ``len(devices)`` equal parts, part i on
    ``devices[i]``. A batch that does not divide is first padded with
    repeats of its last entry (``dp_gather`` drops them): where the JAX
    ``dp_sharding`` replicates such a batch, every device computing all of
    it, the port splits the padded one."""
    n = len(devices)
    pad = -x.shape[0] % n
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
    return [p.to(d) for p, d in zip(x.chunk(n, dim=0), devices)]


def dp_gather(parts, n: int, device):
    """The parts of ``dp_split`` on ``device``, in order, cut to ``n`` entries."""
    return torch.cat([p.to(device) for p in parts], dim=0)[:n]


# ---------------------------------------------------------------------------
# the W axis: spatial parallel
# ---------------------------------------------------------------------------


def shard_w(x, devices, axis: int = W_AXIS):
    """W (``axis``, by default -2) of ``x`` in ``len(devices)`` equal
    shards, shard i on ``devices[i]``; raises unless W divides."""
    n, W = len(devices), x.shape[axis]
    if W % n:
        raise ValueError(f"width {W} does not split into {n} equal shards")
    return [s.to(d) for s, d in zip(x.split(W // n, dim=axis), devices)]


def gather_w(shards, device):
    """The shards side by side along W on ``device``."""
    return torch.cat([s.to(device) for s in shards], dim=W_AXIS)


def halo_w(shards, h: int):
    """Each shard with ``h`` columns of its left and right neighbours on its
    own device (none at the image's true edges: the first shard has no left
    halo, the last no right one). Differentiable: the halo's gradient goes
    back to the neighbour's columns."""
    n = len(shards)
    if n == 1 or h == 0:
        return list(shards)
    if any(s.shape[W_AXIS] < h for s in shards):
        raise ValueError(f"halo of {h} columns wider than a shard: "
                         f"{[s.shape[W_AXIS] for s in shards]}")
    out = []
    for i, s in enumerate(shards):
        parts = []
        if i > 0:
            parts.append(shards[i - 1].narrow(W_AXIS, shards[i - 1].shape[W_AXIS] - h, h).to(s.device))
        parts.append(s)
        if i < n - 1:
            parts.append(shards[i + 1].narrow(W_AXIS, 0, h).to(s.device))
        out.append(torch.cat(parts, dim=W_AXIS))
    return out


def halo_sides(i: int, n: int, h: int) -> tuple[int, int]:
    """The halo columns ``halo_w`` puts on the left and right of shard i of n."""
    return (h if i > 0 else 0), (h if i < n - 1 else 0)


def unhalo_w(padded, h: int):
    """The inverse of ``halo_w``: each shard's own columns."""
    n = len(padded)
    out = []
    for i, p in enumerate(padded):
        left, right = halo_sides(i, n, h)
        out.append(p.narrow(W_AXIS, left, p.shape[W_AXIS] - left - right))
    return out


# ---------------------------------------------------------------------------
# parameters on every device
# ---------------------------------------------------------------------------


class _Apply(nn.Module):
    """Runs ``fn(module, ...)`` as its forward, so that ``functional_call``
    can swap the parameters of ``module`` for a method other than forward."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, fn, *args, **kwargs):
        return fn(self.module, *args, **kwargs)


class Replicas:
    """Each device's copy of the master parameters of a module tree, made on
    first use and kept for the object's life: make one a training step (or a
    ``test()`` call) so that each reads the masters as they are then.
    ``dtype`` casts the copies (a bf16 eval). Under autograd the copies are
    differentiable ``.to`` of the masters, so every device's gradient sums
    into them; on the masters' own device (and dtype) a copy is the master
    itself. A parameter is copied once a device, whichever module asks for
    it; devices that repeat in a mesh share their copies. ``sources`` maps
    a parameter (by ``id``) to the tensor copied in its place (a snapshot
    of the parameters taken earlier: the gradients then sum into it)."""

    def __init__(self, dtype=None, sources=None):
        self.dtype = dtype
        self.sources = sources or {}
        self._copies: dict = {}

    def params(self, device, module) -> dict:
        dev = _device(device)
        out = {}
        for n, p in module.named_parameters():
            key = (str(dev), id(p))
            if key not in self._copies:
                src = self.sources.get(id(p), p)
                self._copies[key] = src.to(dev, self.dtype if self.dtype is not None else src.dtype)
            out[n] = self._copies[key]
        return out

    def __call__(self, device, module, *args, **kwargs):
        """``module(*args, **kwargs)`` with ``device``'s parameters."""
        return torch.func.functional_call(module, self.params(device, module), args, kwargs)

    def apply(self, device, module, fn, *args, **kwargs):
        """``fn(module, *args, **kwargs)`` with ``device``'s parameters."""
        params = {f"module.{n}": p for n, p in self.params(device, module).items()}
        return torch.func.functional_call(_Apply(module), params, (fn, *args), kwargs)
