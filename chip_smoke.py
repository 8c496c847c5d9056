"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, then serves a synthetic
10-frame clip at the Vid4 size through the full-width SelfC_GMM 4x net
(``RescaleModel``: feed_data -> test(gop=7), then downscale / upscale) and
times the kernels beside their roofline bound. Prints one JSON line per
phase; any failure exits non-zero. There is no CPU fallback: without a CUDA
device the script fails at once.

Last lines of the output: a ``{"kernels": [...]}`` object, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.kernels import build
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.train.rescale_model import RescaleModel
from selfc_tpu_torch.utils.bench import (
    CLIP_HW, PATH_WIDTHS, SERVE_SHAPE, chain_bound_ms, make_chain, time_cuda)
from selfc_tpu_torch.utils.metrics import psnr

CHECK_WIDTHS = ((3, 48), (48, 3), (64, 64))           # coupling F/H/G and the prior
CHECK_SHAPE = (1, 3, 40, 52)     # odd sizes on purpose
BLOCK_NUM, STP_BLK_NUM = [4, 4], 6   # the full depth of the published model
FP32_LIMIT = 1e-4                # different summation order of the same fp32 products
BF16_REL_LIMIT = 3e-2            # relative to max |ref|: bf16 keeps 8 bits of mantissa
HR_LIMIT = 1e-3                  # kernel path against plain path through 16 coupling blocks
REPLACES = "selfc_tpu/ops/pallas_chain.py:386"


def check(ok, what):
    """Fail the run (also under ``python -O``, where asserts vanish)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def library_chain(x, ws, bs, w5, b5, a, m):
    """The same chain (mul_add epilogue) through PyTorch's library
    convolutions on NCDHW tensors: the yardstick, never called by the port."""
    feats = x
    for w, b in zip(ws, bs):
        feats = torch.cat([feats, F.leaky_relu(F.conv3d(feats, w, b, padding=(0, 1, 1)), 0.2)], 1)
    return a * m + F.conv3d(feats, w5, b5, padding=(1, 0, 0))


def to_library_layout(x, ws, bs, w5, b5, a, m):
    ncdhw = lambda t: t.permute(0, 4, 1, 2, 3).contiguous()  # noqa: E731
    return (ncdhw(x), [w.permute(3, 2, 0, 1)[:, :, None].contiguous() for w in ws], bs,
            w5.permute(2, 1, 0)[..., None, None].contiguous(), b5, ncdhw(a), ncdhw(m))


@contextlib.contextmanager
def plain_chain_on_card():
    """Route the models' chain calls to the plain version, for comparison."""
    kernel = dc.dense_chain_t_ep
    dc.dense_chain_t_ep = dc.dense_chain_t_ep_plain
    try:
        yield
    finally:
        dc.dense_chain_t_ep = kernel


def seeded_tree(net, seed):
    """Random parameters from a numpy seed, every conv non-zero. conv5 of
    the coupling subnets is scaled down so the latents stay of order one
    through eight blocks."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in net.named_parameters():
        if p.dim() == 1:
            std = 0.05
        else:
            std = float(np.prod(p.shape[:-1])) ** -0.5
            if name.startswith("inv_blocks") and ".conv5." in name:
                std *= 0.25
        tree[name] = rng.normal(0, std, tuple(p.shape)).astype(np.float32)
    return tree


def phase_kernels(device):
    rng = np.random.default_rng(0)
    worst = {w: 0.0 for w in PATH_WIDTHS}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for C, c_out in CHECK_WIDTHS:
            for mode, n_aux in dc.EP_AUX.items():
                x, ws, bs, w5, b5, a, m = make_chain(rng, C, c_out, CHECK_SHAPE, device, dtype)
                aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
                got = dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
                want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                if dtype == torch.float32:
                    ok = err <= FP32_LIMIT
                    worst[(C, c_out)] = max(worst[(C, c_out)], err)
                else:
                    ok = err <= BF16_REL_LIMIT * ref
                cases.append({"dtype": str(dtype).split(".")[-1], "C": C, "c_out": c_out,
                              "mode": mode, "max_abs_err": err, "max_abs_ref": ref, "ok": ok})
                check(ok and np.isfinite(err), f"kernel agrees with its plain version: {cases[-1]}")
    # on a CUDA tensor the wrapper launches or raises: it never takes the plain version
    x, ws, bs, w5, b5, a, m = make_chain(rng, 48, 3, CHECK_SHAPE, device)
    before = dc.launches
    refused = []
    for fault, error, kw in (
        ("strided a", ValueError, dict(a=torch.cat([a, a], -1)[..., :3], m=m)),
        ("float64 x", TypeError, dict(x=x.double(), a=a, m=m)),
        ("requires grad", NotImplementedError, dict(x=x.clone().requires_grad_(True), a=a, m=m)),
    ):
        try:
            with torch.enable_grad():
                dc.dense_chain_t_ep(kw.get("x", x), ws, bs, w5, b5, "mul_add", 1.0, kw["a"], kw["m"])
        except error:
            refused.append(fault)
    check(len(refused) == 3 and dc.launches == before, f"the wrapper refuses bad CUDA arguments: {refused}")
    emit("kernels", kernels=["dense_chain_t_ep"], shape=CHECK_SHAPE, n_cases=len(cases), refused=refused,
         fp32_limit=FP32_LIMIT, bf16_rel_limit=BF16_REL_LIMIT, cases=cases)
    return worst


def serve_options(**val):
    return dict_to_nonedict({
        "model": "SelfC_GMM", "scale": 4, "val": val,
        "network_G": {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": BLOCK_NUM,
                      "scale": 4, "init": "xavier", "global_module": "nonlocal",
                      "stp_blk_num": STP_BLK_NUM, "fh_loss": "gmm", "gmm_k": 5},
    })


def phase_roundtrip(device):
    """Full-width serve of two GOP requests, then one downscale and one
    upscale request; the launch counts of exactly these calls are kept."""
    rng = np.random.default_rng(1)
    # a smooth synthetic clip in [0,1]: low-frequency pattern plus noise
    yy, xx = np.meshgrid(np.linspace(0, 1, CLIP_HW[0]), np.linspace(0, 1, CLIP_HW[1]), indexing="ij")
    frames = [0.5 + 0.3 * np.sin(6 * xx + 0.3 * t)[..., None] * np.cos(4 * yy + 0.2 * t)[..., None]
              * np.array([1.0, 0.8, 0.6]) for t in range(10)]
    clip = np.clip(np.stack(frames)[None] + rng.normal(0, 0.02, (1, 10, *CLIP_HW, 3)), 0, 1)
    clip = clip.astype(np.float32)

    model = RescaleModel(serve_options(), device=device, rng_seed=0)
    tree = seeded_tree(model.net, 2)
    model.load_jax_params(tree)
    n_params = sum(p.numel() for p in model.net.parameters())

    # ---- the main path: counts set to 0 just before, read just after ----
    dc.launches = 0
    dc.launches_by_width.clear()
    model.generator.manual_seed(5)
    t0 = time.time()
    check(model.feed_data({"GT": clip}) == 10, "feed_data returns the clip length")
    model.test(gop=7)
    n_test = dc.launches
    lr_k = model.downscale(clip[:, :7])
    n_down = dc.launches - n_test
    model.generator.manual_seed(6)
    hr_k = model.upscale(lr_k)
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    n_up = dc.launches - n_test - n_down
    counts = {"total": dc.launches, "by_width": dict(dc.launches_by_width)}
    # ---------------------------------------------------------------------

    vis = model.get_current_visuals()
    sr_k, lrs_k = vis["SR"], vis["LR"]
    lat = SERVE_SHAPE[2:]
    check(sr_k.shape == clip.shape, f"SR shape {sr_k.shape}")
    check(lrs_k.shape == (1, 10, *lat, 3), f"LR shape {lrs_k.shape}")
    check(vis["forw_H"].shape == (1, 10, *lat, 48), "forw_H shape")
    check(lr_k.shape == (1, 7, *lat, 3) and hr_k.shape == (1, 7, *CLIP_HW, 3),
          "downscale / upscale shapes")
    for name, arr in (("SR", sr_k), ("LR", lrs_k), ("forw_H", vis["forw_H"]),
                      ("downscale", lr_k), ("upscale", hr_k)):
        check(np.isfinite(arr).all(), f"{name} is finite")
    # two GOPs fold into one encode (3 chains a block) and one decode
    # (the prior's chains + 3 a block)
    n_enc = 3 * sum(BLOCK_NUM)
    n_dec = STP_BLK_NUM + n_enc
    check((n_test, n_down, n_up) == (n_enc + n_dec, n_enc, n_dec),
          f"chain calls of test/downscale/upscale: {(n_test, n_down, n_up)}")
    check(np.abs(lrs_k * 255 - np.round(lrs_k * 255)).max() < 1e-3, "LR lies on 255 levels")

    # the same requests through the plain version of the chain, on the card
    with plain_chain_on_card():
        before = dc.launches
        model.generator.manual_seed(5)
        model.test(gop=7)
        sr_p = model.get_current_visuals()["SR"]
        lr_p = model.downscale(clip[:, :7])
        model.generator.manual_seed(6)
        hr_p = model.upscale(lr_k)  # the same LR and the same eps as the kernel path
        check(dc.launches == before, "the plain path launches no kernel")
    lr_levels_differ = float(np.mean(np.abs(lr_k - lr_p) > 1e-6))
    lr_max = float(np.abs(lr_k - lr_p).max())
    hr_err = float(np.abs(hr_k - hr_p).max())
    # a latent within ~1e-6 of a rounding boundary may land on the other
    # level; more than that, or more than one level, is a fault
    check(lr_levels_differ < 1e-3 and lr_max < 1.01 / 255,
          f"downscale: kernel path vs plain path {(lr_levels_differ, lr_max)}")
    check(hr_err <= HR_LIMIT, f"upscale: kernel path within {HR_LIMIT} of plain path, got {hr_err}")
    flat = lambda v: torch.from_numpy(v).reshape(-1, *v.shape[2:])  # noqa: E731
    emit("roundtrip", clip=clip.shape, n_params=n_params, serve_s=serve_s,
         launches={"test": n_test, "downscale": n_down, "upscale": n_up},
         hr_max_abs_err_kernel_vs_plain=hr_err, hr_limit=HR_LIMIT,
         lr_levels_differ=lr_levels_differ,
         psnr_hr_vs_input=psnr(flat(sr_k), flat(clip)).mean().item(),
         psnr_upscale_kernel_vs_plain=psnr(flat(hr_k), flat(hr_p)).mean().item(),
         psnr_test_kernel_vs_plain=psnr(flat(sr_k), flat(sr_p)).mean().item())

    # bf16 serving mode (val.eval_dtype): runs and stays finite
    bf = RescaleModel(serve_options(eval_dtype="bfloat16"), device=device, rng_seed=0)
    bf.load_jax_params(tree)
    bf.generator.manual_seed(5)
    bf.feed_data({"GT": clip})
    bf.test(gop=7)
    sr_bf = bf.get_current_visuals()["SR"]
    check(np.isfinite(sr_bf).all(), "bf16 SR is finite")
    emit("roundtrip_bf16", psnr_bf16_vs_fp32=psnr(flat(sr_bf), flat(sr_k)).mean().item())
    return model, counts


def chain_error(args, mode):
    """Max abs difference of the kernel and its plain version on one input."""
    x, ws, bs, w5, b5, a, m = args
    n_aux = dc.EP_AUX[mode]
    aa, mm = (a if n_aux >= 1 else None), (m if n_aux >= 2 else None)
    got = dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
    want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, 0.8, aa, mm)
    return (got.float() - want.float()).abs().max().item()


def phase_timing(device, model, counts, worst):
    rng = np.random.default_rng(3)
    kernels, bf16, serve_cases = [], [], []
    for C, c_out in PATH_WIDTHS:
        # every epilogue at the shapes the main path calls with: one GOP
        # (downscale / upscale) and two GOPs folded into the batch (test)
        err = worst[(C, c_out)]
        for B in (2, 1):
            args = make_chain(rng, C, c_out, (B,) + SERVE_SHAPE[1:], device)
            for mode in dc.EP_AUX:
                e = chain_error(args, mode)
                serve_cases.append({"B": B, "C": C, "c_out": c_out, "mode": mode, "max_abs_err": e})
                check(e <= FP32_LIMIT, f"kernel vs plain at the serving shape: {serve_cases[-1]}")
                err = max(err, e)
        x, ws, bs, w5, b5, a, m = args   # B = 1: the shape that is timed
        lib_args = to_library_layout(*args)
        lib = library_chain(*lib_args).permute(0, 2, 3, 4, 1)
        want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 1.0, a, m)
        check((lib - want).abs().max().item() <= 1e-3, "library chain computes the same function")
        del want, lib
        ms = time_cuda(lambda: dc.dense_chain_t_ep(x, ws, bs, w5, b5, "mul_add", 1.0, a, m))
        plain = time_cuda(lambda: dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 1.0, a, m))
        library = time_cuda(lambda: library_chain(*lib_args))
        bound, by = chain_bound_ms(*SERVE_SHAPE, C, c_out, 2)
        kernels.append({
            "name": f"dense_chain_t_ep[{C}->{c_out}]", "route": "cuda",
            "source": "selfc_tpu_torch/csrc/dense_chain.cu", "replaces": REPLACES,
            "launches": counts["by_width"].get((C, c_out), 0),
            "max_abs_err": err, "ms": ms["median"], "plain_ms": plain["median"],
            "bound_ms": bound, "bound_by": by, "library_ms": library["median"],
            "ms_min": ms["min"], "plain_ms_min": plain["min"], "library_ms_min": library["min"],
            "shape": list(SERVE_SHAPE) + [C], "mode": "mul_add",
        })
        hx, hws, hbs, hw5, hb5, ha, hm = [
            [t.bfloat16() for t in v] if isinstance(v, list) else v.bfloat16() for v in args]
        ms16 = time_cuda(lambda: dc.dense_chain_t_ep(hx, hws, hbs, hw5, hb5, "mul_add", 1.0, ha, hm))
        pl16 = time_cuda(lambda: dc.dense_chain_t_ep_plain(hx, hws, hbs, hw5, hb5, "mul_add", 1.0, ha, hm))
        b16, by16 = chain_bound_ms(*SERVE_SHAPE, C, c_out, 2, torch.bfloat16)
        bf16.append({"C": C, "c_out": c_out, "ms": ms16["median"], "ms_min": ms16["min"],
                     "plain_ms": pl16["median"], "plain_ms_min": pl16["min"],
                     "bound_ms": b16, "bound_by": by16})
    emit("kernels_serving_shape", shape=SERVE_SHAPE, n_cases=len(serve_cases),
         fp32_limit=FP32_LIMIT, cases=serve_cases)
    emit("timing_chain_bf16", shape=SERVE_SHAPE, chains=bf16)

    # one GOP roundtrip (encode -> quantize -> prior -> sample -> decode) on the card
    gop = torch.rand((1, 7, *CLIP_HW, 3), device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    eps = torch.randn(model.net.eps_shape(SERVE_SHAPE + (3,)), device=device,
                      generator=torch.Generator(device=device).manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        rt = time_cuda(lambda: model.net.roundtrip(gop, eps=eps), iters=10, warmup=2)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        with plain_chain_on_card():
            rt_plain = time_cuda(lambda: model.net.roundtrip(gop, eps=eps), iters=10, warmup=2)
    # chains of one GOP roundtrip by width: H and G, F, the prior's 64->64, its 3->64
    nb = sum(BLOCK_NUM)
    per_gop = (4 * nb, 2 * nb, STP_BLK_NUM - 1, 1)
    chains_ms = sum(k["ms"] * n for k, n in zip(kernels, per_gop))
    emit("timing_roundtrip", gop_roundtrip_ms=rt["median"], gop_roundtrip_ms_min=rt["min"],
         gop_roundtrip_plain_ms=rt_plain["median"], gop_roundtrip_plain_ms_min=rt_plain["min"],
         chain_launches_per_gop=sum(per_gop), chains_ms_per_gop=chains_ms,
         frames_per_s=7e3 / rt["median"], peak_device_memory_gib=peak_gib)
    return kernels


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    # fp32 references stay fp32: no TF32 in the library's convolutions or products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    build.build()
    for name in build.kernel_names():
        build.load(name)
    ptxas = [ln.split(":", 1)[1].strip() for name in build.kernel_names()
             for ln in build.build_log(name).splitlines() if "registers" in ln]
    emit("build", seconds=time.time() - t0, libraries=build.kernel_names(), ptxas=ptxas)

    with torch.no_grad():
        worst = phase_kernels(device)
        model, counts = phase_roundtrip(device)
        kernels = phase_timing(device, model, counts, worst)

    for k in kernels:
        check(k["launches"] >= 1, f"the main path launched {k['name']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
