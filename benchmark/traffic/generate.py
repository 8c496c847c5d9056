"""The one traffic generator: it reads a mix file (``mixes/<name>.json``)
and makes the cell's inputs from the seed with the frozen renderer. The
length of a clip is the driver's to give: a GOP's for serving, the
configuration's ``video_len`` for the codec eval and for training.

Mix kinds, and the keys each may have (``check_mix`` refuses any other):
  * ``clip_pool``: ``clips`` clips at ``height x width``, uint8, that one
    client sends in a closed loop, ``warmup`` requests before the window
    and ``traced_units`` under the profiler in a traced run; the requests
    cycle through the pool, each pass in an order drawn from the seed, so
    every seed serves the same sizes in another order; with
    ``content_seed`` the clips themselves are the same for every seed;
    ``gop``: the frames of a serving request;
  * ``packed_set``: ``clips`` clips at ``height x width``, uint8, named
    ``clip000``..., to be packed for the program's loader, which crops,
    flips and rotates them as the configuration's ``datasets.train``
    says; ``epoch_ratio`` the loader's passes over the set an epoch,
    ``eps_pool`` the prior's noise tensors a rank cycles through,
    ``traced_units`` the steps under the profiler in a traced run.
"""

from __future__ import annotations

import numpy as np

from .render import render_clip, to_uint8

KEYS = {
    "clip_pool": ({"kind", "clips", "height", "width", "warmup", "traced_units"}, {"gop", "content_seed"}),
    "packed_set": ({"kind", "clips", "height", "width", "epoch_ratio", "eps_pool", "traced_units"}, set()),
}


def check_mix(mix):
    """Refuse a mix whose kind is unknown, or that lacks a key of its kind
    or has a key that nothing reads."""
    if mix.get("kind") not in KEYS:
        raise ValueError(f"mix kind {mix.get('kind')!r}: not one of {sorted(KEYS)}")
    need, may = KEYS[mix["kind"]]
    missing, extra = need - set(mix), set(mix) - need - may
    if missing or extra:
        raise ValueError(f"{mix['kind']} mix: missing {sorted(missing)}, not read {sorted(extra)}")


def _clip(rng, mix, frames):
    return np.stack([to_uint8(f) for f in render_clip(rng, frames, mix["height"], mix["width"])])


def clip_pool(mix, seed, frames):
    """The pool of a ``clip_pool`` mix: a list of ``(frames, H, W, 3)``
    uint8 clips, drawn from the run's seed, or from the mix's
    ``content_seed`` where the work depends on what the frames show (so
    that every seed serves the same clips, in its own order)."""
    rng = np.random.default_rng([int(mix.get("content_seed", seed)) % 2 ** 64, 11])
    return [_clip(rng, mix, frames) for _ in range(mix["clips"])]


def request_order(mix, seed, n):
    """The pool indices of the first ``n`` requests: passes over the whole
    pool, each in an order drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 12])
    order = []
    while len(order) < n:
        order += rng.permutation(mix["clips"]).tolist()
    return order[:n]


def packed_clips(mix, seed, frames):
    """The clips of a ``packed_set`` mix: ``[(name, (frames, H, W, 3)
    uint8)]``."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, 13])
    return [(f"clip{v:03d}", _clip(rng, mix, frames)) for v in range(mix["clips"])]
