"""Rescaling model wrapper — the serving half of the JAX package's
``RescaleModel``: feed_data / test / downscale / upscale /
get_current_visuals. Training arrives with the backward kernels.

All host I/O is channels-last numpy ``(B, T, H, W, 3)``.
"""

from __future__ import annotations

import copy
import logging
from collections import OrderedDict

import numpy as np
import torch

from .. import resolve_device
from ..models import define_G
from ..ops.quantize import quantize_ste
from ..utils.jax_import import load_jax_params

logger = logging.getLogger("base")


class RescaleModel:
    """Eval wrapper for the SelfC_GMM model type."""

    def __init__(self, opt, device=None, rng_seed: int = 0):
        """``device=None`` means the GPU (raises without one).
        ``val.sample_seed`` overrides ``rng_seed``: it seeds both the
        parameter initialisation and the generator the GMM prior draws its
        eval noise from."""
        cfg_seed = (opt.get("val") or {}).get("sample_seed")
        if cfg_seed is not None:
            rng_seed = int(cfg_seed)
        self.opt = opt
        self.device = resolve_device(device)
        self.scale = opt["scale"]
        init_gen = torch.Generator().manual_seed(rng_seed)
        self.net = define_G(opt, device=self.device, generator=init_gen)
        self.net.eval()
        self._net_cast = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)

    # ------------------------------------------------------------------
    def load_jax_params(self, tree):
        """Parameters in the JAX package's tree (numpy leaves) -> the net."""
        load_jax_params(self.net, tree)
        self._net_cast = None

    def _eval_dtype(self):
        """val.eval_dtype: bfloat16 switches the eval roundtrip to bf16
        activations and parameters; outputs return as fp32 so the STE
        quantization and the metrics are unaffected. Default fp32."""
        name = str((self.opt.get("val") or {}).get("eval_dtype") or "float32").lower()
        if name in ("bf16", "bfloat16"):
            return torch.bfloat16
        if name in ("f32", "fp32", "float32"):
            return None
        raise ValueError(f"val.eval_dtype {name!r}")

    def _net_for(self, dt):
        if dt is None:
            return self.net
        if self._net_cast is None:
            self._net_cast = copy.deepcopy(self.net).to(dt)
        return self._net_cast

    @torch.no_grad()
    def _encode(self, x):
        dt = self._eval_dtype()
        y, _ = self._net_for(dt).encode(x if dt is None else x.to(dt))
        return y.float()

    @torch.no_grad()
    def _decode(self, lr, eps):
        dt = self._eval_dtype()
        hr, hf = self._net_for(dt).decode(lr if dt is None else lr.to(dt), eps=eps)
        return hr.float(), hf.float()

    def _draw_eps(self, lr_shape):
        return torch.randn(self.net.eps_shape(lr_shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)

    # ------------------------------------------------------------------
    def feed_data(self, data):
        """data['GT']: numpy (B, T, H, W, 3) RGB in [0,1] (or uint8)."""
        gt = np.asarray(data["GT"])
        x = torch.from_numpy(np.ascontiguousarray(gt)).to(self.device)
        self.real_H = x.float() / 255.0 if gt.dtype == np.uint8 else x.float()
        return gt.shape[1]

    def test(self, gop: int = 7):
        """GOP-chunked eval roundtrip: encode -> split -> quantize ->
        decode per ``gop``-frame group, the last group padded by repeating
        the final frame.

        ``val.gop_batch: N`` folds N independent GOPs into the batch axis
        of ONE encode + ONE decode call (unset: up to 4; 1 = sequential
        calls). The trailing call is padded with repeats of its last GOP.
        One ``eps`` is drawn per real group from the model's generator, in
        the order of the sequential path, so the sample stream does not
        depend on ``gop_batch``."""
        x = self.real_H
        B, T = x.shape[:2]
        n_groups = -(-T // gop)
        n_batch = (self.opt.get("val") or {}).get("gop_batch")
        if n_batch is None:
            n_batch = max(1, min(4, n_groups))
        n_batch = int(n_batch)

        groups = []
        for start in range(0, T, gop):
            idx = list(range(start, min(start + gop, T)))
            orig = len(idx)
            idx += [T - 1] * (gop - orig)
            groups.append((torch.as_tensor(idx, device=self.device), orig))

        fake_H, forw_L, forw_Hf, sample_H = [], [], [], []
        for i in range(0, len(groups), n_batch):
            grp = groups[i:i + n_batch]
            pad_grp = grp + [grp[-1]] * (n_batch - len(grp))
            chunk = torch.cat([x[:, g[0]] for g in pad_grp], dim=0)
            y = self._encode(chunk)
            lr = quantize_ste(y[..., :3].contiguous())
            eps = [self._draw_eps((B,) + tuple(lr.shape[1:])) for _ in grp]
            eps += [eps[-1]] * (n_batch - len(grp))
            hr, hf = self._decode(lr, torch.cat(eps, dim=0))
            for j, (_, orig) in enumerate(grp):
                sl = slice(j * B, (j + 1) * B)
                fake_H.append(hr[sl, :orig])
                forw_L.append(lr[sl, :orig])
                forw_Hf.append(y[sl, :orig, ..., 3:])
                sample_H.append(hf[sl, :orig])
        self.fake_H = torch.cat(fake_H, dim=1).cpu().numpy()
        self.forw_L = torch.cat(forw_L, dim=1).cpu().numpy()
        self.forw_H = torch.cat(forw_Hf, dim=1).cpu().numpy()
        self.sample_H = torch.cat(sample_H, dim=1).cpu().numpy()

    def downscale(self, hr):
        x = torch.as_tensor(np.asarray(hr), dtype=torch.float32, device=self.device)
        y = self._encode(x)
        return quantize_ste(y[..., :3].contiguous()).cpu().numpy()

    def upscale(self, lr):
        x = torch.as_tensor(np.asarray(lr), dtype=torch.float32, device=self.device)
        hr, _ = self._decode(x, self._draw_eps(x.shape))
        return hr.cpu().numpy()

    def get_current_visuals(self):
        out = OrderedDict()
        out["SR"] = self.fake_H
        out["LR"] = self.forw_L
        out["GT"] = self.real_H.cpu().numpy()
        out["forw_H"] = self.forw_H
        return out
