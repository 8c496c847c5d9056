"""The learned, differentiable codec surrogate (correlation-augmented) and
the host codec span of a training step; the JAX package's
``codec/surrogate.py`` (reference Quantization_h265_suggrogate_correlation1.py
and Quantization_h265_suggrogate.py).

The surrogate net predicts the codec's reconstruction of the quantised LR.
Training uses

  mimick = MSE(codec, sug) - lambda_corr * Pearson(codec, sug)

and the value swap ``sug + (codec - sug).detach()``: the forward value is the
codec's output, the gradient the surrogate's. The real codec runs on the
host between the encode and the loss (``h265_host_roundtrip``); it has no
gradient.

Parameters keep the JAX tree's names and layouts
(``suggrogate_net.net_{i}.chain.conv{k}.{weight,bias}``,
``fuser_{i}.{kernel,bias}``), so ``utils/jax_import.py`` copies them as they
are.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn as nn

from ..models.blocks import DenseBlock2D, FeatureCollapse
from .h265 import encode_decode_clip, ffmpeg_available


class _Dense(nn.Module):
    """flax ``nn.Dense`` in its own layout: ``kernel (in, out)``, ``bias
    (out,)``, ``y = x @ kernel + bias`` (a ``nn.Linear`` whose weight is
    stored transposed). Kernel init lecun normal, bias zero."""

    def __init__(self, c_in, c_out, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.randn((c_in, c_out), generator=generator) / math.sqrt(c_in))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class SurrogateNet(nn.Module):
    """The suggrogate_net stack (reference :91-104) on (B,T,h,w,4) video."""

    def __init__(self, mid_c=24, generator=None):
        super().__init__()
        m, g = mid_c, generator
        self.net_0 = DenseBlock2D(4, m, init_mode="plain_xavier", generator=g)
        self.net_1 = DenseBlock2D(m, m, init_mode="plain_xavier", is_res=True, generator=g)
        self.net_2 = FeatureCollapse(m, m, 4, init_mode="inn_xavier", is_res=True, generator=g)
        self.net_3 = FeatureCollapse(m, m, 4, init_mode="inn_xavier", is_res=True, generator=g)
        self.net_4 = DenseBlock2D(m, m, init_mode="plain_xavier", is_res=True, generator=g)
        self.net_5 = DenseBlock2D(m, 3, init_mode="plain_xavier", generator=g)

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f"net_{i}")(x)
        return x


class H265Surrogate(nn.Module):
    """The surrogate's prediction from the quantised LR video and the codec
    q. ``dynamic_q`` adds the (t, q/30) token MLP of the reference
    (:105-135); without it the indicator plane is t alone."""

    def __init__(self, dynamic_q=False, generator=None):
        super().__init__()
        self.dynamic_q = bool(dynamic_q)
        if self.dynamic_q:
            self.fuser_0 = _Dense(2, 256, generator)
            self.fuser_1 = _Dense(256, 256, generator)
            self.fuser_2 = _Dense(256, 1, generator)
        self.suggrogate_net = SurrogateNet(generator=generator)

    def forward(self, lr, q_value=None):
        B, T, h, w, _ = lr.shape
        t_ind = torch.linspace(0.0, 1.0, T, device=lr.device)
        if not self.dynamic_q:
            ind = t_ind[None, :, None, None, None]
        else:
            tok = torch.stack([t_ind, torch.full((T,), float(q_value) / 30.0, device=lr.device)], dim=1)
            tok = torch.relu(self.fuser_0(tok))
            tok = torch.relu(self.fuser_1(tok))
            ind = self.fuser_2(tok)[None, :, None, None, :]  # (1, T, 1, 1, 1)
        # the fp32 indicator promotes a bf16 lr, as jnp.concatenate does
        x = torch.cat([lr, ind.expand(B, T, h, w, 1)], dim=-1)
        return self.suggrogate_net(x) + lr


class SurrogateNetPlain(nn.Module):
    """The plain variant's 10-block stack (reference
    Quantization_h265_suggrogate.py:84-97): no residual connections, plain
    init everywhere, 3-channel input (no indicator)."""

    def __init__(self, mid_c=24, generator=None):
        super().__init__()
        m, g = mid_c, generator
        self.net_0 = DenseBlock2D(3, m, init_mode="plain_xavier", generator=g)
        self.net_1 = DenseBlock2D(m, m, init_mode="plain_xavier", generator=g)
        for i in range(6):
            setattr(self, f"net_{2 + i}", FeatureCollapse(m, m, 4, init_mode="plain_xavier", generator=g))
        self.net_8 = DenseBlock2D(m, m, init_mode="plain_xavier", generator=g)
        self.net_9 = DenseBlock2D(m, 3, init_mode="plain_xavier", generator=g)

    def forward(self, x):
        for i in range(10):
            x = getattr(self, f"net_{i}")(x)
        return x


class H265SurrogatePlain(nn.Module):
    """The plain (no-indicator) surrogate: fixed q only, no residual add;
    its loss is ``mimick_plain``. ``q_value`` is accepted and ignored."""

    def __init__(self, generator=None):
        super().__init__()
        self.suggrogate_net = SurrogateNetPlain(generator=generator)

    def forward(self, lr, q_value=None):
        return self.suggrogate_net(lr)


def mimick_plain(sug, codec_out):
    """The plain variant's loss: MSE against the detached codec output; the
    value stays the surrogate's prediction (no swap). Returns
    ``(sug, mimick)``."""
    return sug, torch.mean((codec_out.detach() - sug) ** 2)


def mimick_and_swap(sug, codec_out, lambda_corr: float):
    """The mimick loss and the value swap (reference :141-156). The Pearson
    correlation is taken per element over the flattened B*T axis, then
    meaned. Returns ``(swapped, loss)``."""
    x = codec_out.detach()
    B, T = sug.shape[:2]
    xf = x.reshape(B * T, *x.shape[2:])
    yf = sug.reshape(B * T, *sug.shape[2:])
    mimick = torch.mean((xf - yf) ** 2)
    vx = xf - xf.mean(dim=0, keepdim=True)
    vy = yf - yf.mean(dim=0, keepdim=True)
    corr = torch.sum(vx * vy, dim=0, keepdim=True) / (
        torch.sqrt(torch.sum(vx ** 2, dim=0, keepdim=True))
        * torch.sqrt(torch.sum(vy ** 2, dim=0, keepdim=True)) + 1e-8)
    swapped = sug + (codec_out - sug).detach()
    return swapped, mimick - lambda_corr * corr.mean()


def h265_host_roundtrip(lr: np.ndarray, q: int, keyint: int, scale_times: int,
                        h265_all_default: bool = False, stand_in: str | None = None):
    """The host codec span of a training step: ``(B,T,h,w,3)`` float in
    [0,1] -> ``(decoded, mean_bpp)``, clip by clip. A real x265 backend
    where there is one (a decode that comes back short returns the clip
    itself, as the reference does, SelfC_Codec_arch_inv.py:473-476);
    otherwise the zlib stand-in (``stand_in`` 'zlib', the default from
    ``$SELFC_TPU_STANDIN_CODEC``) or 8-bit rounding with a bpp of 0. The
    clips go through a pool of threads (``$SELFC_TPU_CODEC_WORKERS``, by
    default the CPUs less two); the results are those of the serial loop,
    in batch order."""
    lr = np.asarray(lr)
    B, T = lr.shape[:2]
    if stand_in is None:
        stand_in = os.environ.get("SELFC_TPU_STANDIN_CODEC", "zlib")

    def one(b):
        clip = np.clip(lr[b], 0, 1)
        if ffmpeg_available():
            dec, bpp = encode_decode_clip(clip, int(q), keyint, scale_times, h265_all_default)
            if dec.shape[0] < T:
                dec = clip
        elif str(stand_in).lower() == "zlib":
            from .standin import zlib_encode_decode_clip

            dec, bpp = zlib_encode_decode_clip(clip, int(q), keyint, scale_times, h265_all_default)
        else:
            dec, bpp = (clip * 255.0).round() / 255.0, 0.0
        return dec.astype(np.float32), bpp

    workers = int(os.environ.get("SELFC_TPU_CODEC_WORKERS") or 0) or min(
        B, max(1, (os.cpu_count() or 8) - 2))
    if B > 1 and workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(workers, B)) as ex:
            results = list(ex.map(one, range(B)))
    else:
        results = [one(b) for b in range(B)]
    return np.stack([r[0] for r in results], axis=0), float(np.mean([r[1] for r in results]))
