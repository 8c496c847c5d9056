"""The synthetic val set, rendered in memory: the port's copy of the JAX
package's ``tools/make_synth_data.py`` (``render_clip`` and the uint8
rounding of ``write_dataset``), numpy alone.

Textured sprites (sinusoid gratings, checkers, gaussian bumps) move over
drifting multi-scale background gratings with a global camera pan and a
per-clip gain. ``render_val_set()``'s defaults are the val set the trained
iter-164,339 checkpoint was validated on (4 clips of 7 frames at 576 x 704,
seed 7); its frames are the bits the JAX package's PNG writer and packed
loader give (``uint8 / 255``), with no PNG written and no cv2.
"""

from __future__ import annotations

import numpy as np


def _grating(h, w, fx, fy, phase):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return 0.5 + 0.5 * np.sin(2 * np.pi * (fx * xx / w + fy * yy / h) + phase)


def _checker(h, w, cell):
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy // cell) + (xx // cell)) % 2).astype(np.float32)


def _bump(h, w, sigma):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    return np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)))


def render_clip(rng, frames, h, w):
    """``frames`` float32 (h, w, 3) RGB frames in [0, 1] drawn from ``rng``."""
    pad = 32
    H, W = h + 2 * pad, w + 2 * pad
    # background: 3 drifting low-frequency gratings, one per channel twist
    bg_specs = [(rng.uniform(0.5, 3), rng.uniform(0.5, 3),
                 rng.uniform(0, 2 * np.pi), rng.uniform(-2, 2),
                 rng.uniform(-2, 2)) for _ in range(3)]
    n_sprites = rng.integers(3, 7)
    sprites = []
    for _ in range(n_sprites):
        size = int(rng.integers(16, 48))
        kind = rng.integers(0, 3)
        if kind == 0:
            tex = _grating(size, size, rng.uniform(2, 8), rng.uniform(2, 8),
                           rng.uniform(0, 2 * np.pi))
        elif kind == 1:
            tex = _checker(size, size, int(rng.integers(2, 7)))
        else:
            tex = _bump(size, size, size / rng.uniform(3, 6))
        color = rng.uniform(0.2, 1.0, size=3).astype(np.float32)
        pos = rng.uniform([0, 0], [H - size, W - size])
        vel = rng.uniform(-3.0, 3.0, size=2)
        mask = _bump(size, size, size / 2.2) > 0.35
        sprites.append([tex, color, pos, vel, size, mask])
    cam_vel = rng.uniform(-1.5, 1.5, size=2)
    cam = np.array([pad / 2, pad / 2], np.float32)
    gain = rng.uniform(0.85, 1.0)

    out = []
    for t in range(frames):
        frame = np.zeros((H, W, 3), np.float32)
        for c, (fx, fy, ph, vx, vy) in enumerate(bg_specs):
            frame[..., c] = 0.25 + 0.45 * _grating(
                H, W, fx, fy, ph + 0.15 * t * (vx + vy)
            )
        for sp in sprites:
            tex, color, pos, vel, size, mask = sp
            y0, x0 = int(round(pos[0])), int(round(pos[1]))
            y0 = max(0, min(H - size, y0))
            x0 = max(0, min(W - size, x0))
            region = frame[y0:y0 + size, x0:x0 + size]
            blend = tex[..., None] * color[None, None]
            region[mask] = 0.3 * region[mask] + 0.7 * blend[mask]
            pos += vel
            if not (0 <= pos[0] <= H - size):
                vel[0] = -vel[0]
            if not (0 <= pos[1] <= W - size):
                vel[1] = -vel[1]
        cy, cx = (cam + cam_vel * t).astype(int)
        cy = max(0, min(2 * pad - 1, cy))
        cx = max(0, min(2 * pad - 1, cx))
        crop = frame[cy:cy + h, cx:cx + w]
        out.append(np.clip(crop * gain, 0, 1))
    return out


def to_uint8(frame):
    """A rendered frame as the dataset writer stores it."""
    return (frame * 255 + 0.5).astype(np.uint8)


def render_val_set(clips=4, frames=7, h=576, w=704, seed=7):
    """Yield the val clips as the JAX package's packed val loader gives
    them at batch 1: ``{"GT": (1, frames, h, w, 3) float32 = uint8 / 255,
    "LQ_path": ["clip{v:03d}/im1.png"]}``. One generator across the clips."""
    rng = np.random.default_rng(seed)
    for v in range(clips):
        u8 = np.stack([to_uint8(fr) for fr in render_clip(rng, frames, h, w)])
        yield {"GT": (u8.astype(np.float32) / 255.0)[None], "LQ_path": [f"clip{v:03d}/im1.png"]}
