"""The compression eval: one client in a closed loop sends the next clip of
the pool (uint8 frames) through ``feed_data`` -> ``CodecModel.test()`` (the
streaming pipeline: the encode call, the host codec, the decode call) and
takes the visuals and the bpp to the host. The host codec is the program's
zlib stand-in, as the configuration assumes (the card's machine has no
x265).

``correct``: once the window has closed, a sample of the clips drawn from
the seed (and the last one) is judged by the plain reference on the card,
fp32 with TF32 off, tile by tile as the eval tiles them: the decoded LR by
how far the reference's LR lies outside the levels that the rounding and
the codec's requantisation map onto the program's (in 8-bit levels), the
SR against the reference's decode of the program's decoded LR (largest
gap), and the bpp against the frozen codec's bitstream of the program's
decoded LR (exactly). The SR is judged on the program's decoded LR, not
the reference's own: the codec requantises the LR, so a level that the two
round apart at a pixel may land in another bin, and the decode would then
differ by what the codec moved, not by what the decode computes; the LR
itself is held by ``lr_excess``.

A clip is ``video_len`` frames, the configuration's."""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import faults
from ..harness import closed_loop, sub_seed
from ..reference import codec_plain as CP
from ..reference import zlib_codec
from ..traffic import generate


def program(run, tree):
    """The port's codec model with the benchmark's weights, on the zlib
    stand-in."""
    os.environ["SELFC_TPU_DISABLE_X265"] = "1"
    from selfc_tpu_torch.config import dict_to_nonedict
    from selfc_tpu_torch.train.codec_model import CodecModel

    cfg = run.cfg
    opt = dict_to_nonedict({"model": cfg["model"], "scale": cfg["scale"], "distortion": cfg["distortion"],
                            "network_G": cfg["network_G"],
                            "val": {"seg_batch": cfg["val"]["seg_batch"], "batch_tiles": cfg["val"]["batch_tiles"],
                                    "standin_codec": "zlib"}})
    model = CodecModel(opt, device=run.device)
    if model.rate_source != "zlib":
        raise RuntimeError(f"the codec cell assumes the zlib stand-in; the program resolved {model.rate_source}")
    model.load_jax_params(tree)
    return model


def work(r):
    """One clip's work (the configuration's ``val``): segments of
    ``seg_len`` frames, each encoded as ``divide_width_num`` slices of its
    width and decoded as ``divide_height_num x divide_width_num`` tiles of
    the LR; the chain forward of both calls and their products."""
    k, ev, mix = r.cfg["scale"], r.cfg["val"], r.mix
    seg, H, W = ev["seg_len"], mix["height"], mix["width"]
    n_seg = r.cfg["video_len"] // seg
    dh, dw = ev["divide_height_num"], ev["divide_width_num"]
    enc = r.work_model.roundtrip_work(r.cfg, (n_seg * dw, seg, H // k, W // dw // k), "encode")
    dec = r.work_model.roundtrip_work(r.cfg, (n_seg * dh * dw, seg, H // k // dh, W // k // dw), "decode")
    return {key: enc[key] + dec[key] for key in ("chain_fwd_ops", "chain_fwd_bound_s", "ops")}


class Control:
    """``CodecModel``'s eval calls, by the plain reference in TF32."""

    def __init__(self, run, tree):
        self.ref, self.dev, self.cfg = run.ref, run.device, run.cfg
        self.net = run.ref.Net(tree, run.cfg)

    def feed_data(self, data):
        self.video = torch.from_numpy(data["GT"][0]).to(self.dev).float() / 255.0

    def test(self):
        with torch.no_grad(), self.ref.precision(True):
            lr, hr, self.bpp = CP.roundtrip(self.net, self.video, self.cfg)
        self.vis = {"LR": lr.cpu().numpy()[None], "SR": hr.cpu().numpy()[None]}

    def get_current_visuals(self):
        return self.vis

    def get_current_metrics(self):
        return {"video_bpp": self.bpp}


FAULTS = (faults.AlteredAnswer,)


def serve(model, clip):
    """One clip: its decoded LR, its SR and its bpp on the host."""
    model.feed_data({"GT": clip[None]})
    model.test()
    vis = model.get_current_visuals()
    return vis["LR"], vis["SR"], model.get_current_metrics()["video_bpp"]


def run(r):
    mix, chk = r.mix, r.cell["check"]
    pool = generate.clip_pool(mix, r.seed, r.cfg["video_len"])
    order = generate.request_order(mix, r.seed, 1 << 12)
    r.mark("traffic")
    tree = r.weights()
    model = (r.make_program or program)(r, tree)
    r.mark("program")
    for i in range(mix["warmup"]):
        serve(model, pool[order[i]])
        r.mark(f"warmup{i}")
    rng = np.random.default_rng(sub_seed(r.seed, 3))
    n_units = mix["traced_units"] if r.trace else None
    among = min(chk["among_first"], n_units or chk["among_first"])
    picks = set(rng.choice(among, size=min(chk["sampled"], among), replace=False).tolist())
    w = closed_loop(r, lambda j: serve(model, pool[order[j]]), mix["warmup"], picks, n_units)
    lat = w["lat"]
    out = {"work": work(r)}
    if r.trace:
        out.update({k: w[k] for k in ("attr", "units", "wall_s", "traced_wall_s")})
    else:
        window = w["t_last"] - w["t0"]
        out["e2e"] = {"codec_fps": len(lat) * r.cfg["video_len"] / window}
        r.info(clips=len(lat), clip_s=lat, window_s=window)
    out["memory_peak_bytes"] = r.peak_bytes()
    out["attempted"], out["failed"] = len(lat), 0
    del model
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(r, tree, pool, order, w["kept"])
    return out


def check(r, tree, pool, order, kept, tf32=False):
    """The compared numbers over the kept clips: ``{name: value}``."""
    dev, ev = r.device, r.cfg["val"]
    net_cfg = r.cfg["network_G"]
    step = zlib_codec.q_to_step(net_cfg["h265_q"])
    lr_excess = sr_gap = bpp_gap = 0.0
    with torch.no_grad(), r.ref.precision(tf32):
        net = r.ref.Net(tree, r.cfg)
        for j, (lr, sr, bpp) in sorted(kept.items()):
            video = torch.from_numpy(pool[order[j]]).to(dev).float() / 255.0
            v = CP.encode_lr(net, video, ev["seg_len"], ev["divide_width_num"]).clamp(0.0, 1.0) * 255.0
            lo, hi = zlib_codec.levels_of(np.rint(lr[0] * 255.0).astype(np.uint8), step)
            lo = torch.from_numpy(lo).to(dev) - 0.5
            hi = torch.from_numpy(hi).to(dev) + 0.5
            lr_excess = max(lr_excess, float(torch.maximum(lo - v, v - hi).clamp_min(0.0).max()))
            lr_t = torch.from_numpy(lr[0]).to(dev)
            hr = CP.decode_hr(net, lr_t, ev["seg_len"], ev["divide_height_num"], ev["divide_width_num"])
            sr_gap = max(sr_gap, float((torch.from_numpy(sr[0]).to(dev) - hr).abs().max()))
            _, bpp_ref = zlib_codec.roundtrip(lr[0], net_cfg["h265_q"], net_cfg["h265_keyint"], r.cfg["scale"])
            bpp_gap = max(bpp_gap, abs(bpp - bpp_ref))
    r.info(checked_clips=sorted(kept))
    return {"lr_excess": lr_excess, "sr_gap": sr_gap, "bpp_gap": bpp_gap}
