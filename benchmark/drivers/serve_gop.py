"""GOP serving through the 4x rescaling net: one client in a closed loop
sends the next GOP of the pool (uint8 frames) and waits for its SR and LR
on the host: ``feed_data`` -> ``test(gop)`` -> ``get_current_visuals()``.
The prior's noise comes from the model's generator, seeded for each request
from the run's seed.

``correct``: once the window has closed, a sample of the requests drawn
from the seed (and the last one) is judged by the plain reference on the
card, fp32 with TF32 off: the encode (the HF latents, relative to their
largest value; the 255-level LR, by how far it lies outside the rounding
of the reference's LR, in levels) and the decode of the program's LR with
the request's noise (the SR's largest gap). The decode is judged on the
program's LR, not the reference's own: the two LRs may round apart by a
level at a few pixels (``lr_excess`` holds that), and a decode of the
reference's LR would then differ there by what the rounding moved, not by
what the decode computes.

``gop_ms.p95`` and the p50 are printed on an earlier line, not reported as
metrics: with one client in a closed loop the service is never idle, so
the tail is the whole distribution's shift with the host's load plus its
jitter, and spreads wider run to run than a bound can hold."""

from __future__ import annotations

import numpy as np
import torch

from .. import faults
from ..harness import closed_loop, sub_seed
from ..traffic import generate
from ..yardstick import stats


def program(run, tree):
    """The port's serving model with the benchmark's weights."""
    from selfc_tpu_torch.config import dict_to_nonedict
    from selfc_tpu_torch.train.rescale_model import RescaleModel

    cfg = run.cfg
    opt = dict_to_nonedict({"model": cfg["model"], "scale": cfg["scale"], "distortion": cfg["distortion"],
                            "network_G": cfg["network_G"], "val": {}})
    model = RescaleModel(opt, device=run.device)
    model.load_jax_params(tree)
    return model


def work(r):
    """One GOP's work: its roundtrip's chain forward and products."""
    k = r.cfg["scale"]
    w = r.work_model.roundtrip_work(r.cfg, (1, r.mix["gop"], r.mix["height"] // k, r.mix["width"] // k))
    return {key: v for key, v in w.items() if not key.startswith("chain_bwd")}


class Control:
    """``RescaleModel``'s serving calls, by the plain reference in TF32."""

    def __init__(self, run, tree):
        self.ref, self.dev = run.ref, run.device
        self.net = run.ref.Net(tree, run.cfg)
        self.generator = torch.Generator(device=run.device)

    def feed_data(self, data):
        self.x = torch.from_numpy(data["GT"]).to(self.dev).float() / 255.0

    def test(self, gop):
        with torch.no_grad(), self.ref.precision(True):
            y = self.net.encode(self.x)
            lr = self.ref.quantize(y[..., :3])
            eps = torch.randn((*lr.shape[:-1], self.net.hf_dim, self.net.K), generator=self.generator,
                              device=self.dev)
            sr = self.net.decode(lr, eps)
        self.vis = {"SR": sr.cpu().numpy(), "LR": lr.cpu().numpy(), "forw_H": y[..., 3:].cpu().numpy()}

    def get_current_visuals(self):
        return self.vis


FAULTS = (faults.AlteredAnswer,)


def serve(model, gop, noise_seed, frames):
    """One request: the GOP in, its SR, LR and HF latents on the host."""
    model.generator.manual_seed(noise_seed)
    model.feed_data({"GT": gop[None]})
    model.test(gop=frames)
    vis = model.get_current_visuals()
    return vis["SR"], vis["LR"], vis["forw_H"]


def run(r):
    mix, chk = r.mix, r.cell["check"]
    pool = generate.clip_pool(mix, r.seed, mix["gop"])
    order = generate.request_order(mix, r.seed, 1 << 16)
    r.mark("traffic")
    tree = r.weights()
    model = (r.make_program or program)(r, tree)
    r.mark("program")

    def noise(i):
        return sub_seed(r.seed, 2, i)

    for i in range(mix["warmup"]):
        serve(model, pool[order[i]], noise(i), mix["gop"])
        r.mark(f"warmup{i}")
    rng = np.random.default_rng(sub_seed(r.seed, 3))
    n_units = mix["traced_units"] if r.trace else None
    among = min(chk["among_first"], n_units or chk["among_first"])
    picks = set(rng.choice(among, size=min(chk["sampled"], among), replace=False).tolist())
    w = closed_loop(r, lambda j: serve(model, pool[order[j]], noise(j), mix["gop"]), mix["warmup"], picks, n_units)
    lat = w["lat"]
    out = {"work": work(r)}
    if r.trace:
        out.update({k: w[k] for k in ("attr", "units", "wall_s", "traced_wall_s")})
    else:
        window = w["t_last"] - w["t0"]
        out["e2e"] = {"rescale_fps": len(lat) * mix["gop"] / window}
        r.info(requests=len(lat), gop_ms_p50=stats.percentile(lat, 50) * 1e3,
               gop_ms_p95=stats.percentile(lat, 95) * 1e3, gop_ms_max=max(lat) * 1e3, window_s=window)
    out["memory_peak_bytes"] = r.peak_bytes()
    out["attempted"], out["failed"] = len(lat), 0
    del model
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(r, tree, pool, order, w["kept"], noise)
    return out


def check(r, tree, pool, order, kept, noise, tf32=False):
    """The compared numbers over the kept requests: ``{name: value}``."""
    dev = r.device
    hf_gap = lr_excess = sr_gap = 0.0
    with torch.no_grad(), r.ref.precision(tf32):
        net = r.ref.Net(tree, r.cfg)
        for j, (sr, lr, hf) in sorted(kept.items()):
            x = torch.from_numpy(pool[order[j]]).to(dev)[None].float() / 255.0
            y = net.encode(x)
            hf_ref = y[..., 3:]
            hf_gap = max(hf_gap, float((torch.from_numpy(hf).to(dev) - hf_ref).abs().max() / hf_ref.abs().max()))
            lr_t = torch.from_numpy(lr).to(dev)
            off = (lr_t * 255.0 - y[..., :3].clamp(0.0, 1.0) * 255.0).abs() - 0.5
            lr_excess = max(lr_excess, float(off.clamp_min(0.0).max()))
            g = torch.Generator(device=dev).manual_seed(noise(j))
            eps = torch.randn((*lr_t.shape[:-1], net.hf_dim, net.K), generator=g, device=dev)
            sr_gap = max(sr_gap, float((torch.from_numpy(sr).to(dev) - net.decode(lr_t, eps)).abs().max()))
    r.info(checked_requests=sorted(kept))
    return {"hf_gap": hf_gap, "lr_excess": lr_excess, "sr_gap": sr_gap}
