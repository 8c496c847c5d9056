"""The plain reference against the port's plain path on the CPU, at tiny
sizes: the same seeded weights and inputs give the same encode, decode,
codec tiles, LR target, training loss and step. (This test imports the
port; the reference never does.)"""

import numpy as np
import pytest
import torch

from benchmark.reference import codec_plain as CP
from benchmark.reference import selfc_plain as R
from benchmark.reference import zlib_codec
from benchmark.tests.tiny import tiny_run

from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models import define_G
from selfc_tpu_torch.utils.jax_import import load_jax_params

TOL = 2e-6


def _net(r):
    net = define_G(dict_to_nonedict({k: r.cfg[k] for k in ("model", "scale", "network_G")}), device="cpu")
    tree = r.weights()
    load_jax_params(net, tree)
    return net, tree


@pytest.mark.parametrize("config, count", [("gmm4x.serve.gop", 3365038), ("codec.uvg.test", 885524)])
def test_parameter_shapes_are_the_programs(config, count):
    r = tiny_run(config)
    r.cfg["network_G"].update(block_num=[4, 4] if count == 3365038 else [4],
                              stp_blk_num=6 if count == 3365038 else 4)
    net = define_G(dict_to_nonedict({k: r.cfg[k] for k in ("model", "scale", "network_G")}), device="cpu")
    shapes = R.param_shapes(r.cfg)
    assert shapes == {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == count == r.cfg["parameters"]


def test_seeded_weights_have_no_zero_leaf():
    tree = tiny_run("gmm4x.serve.gop").weights()
    assert all(float(v.abs().min()) > 0 or v.numel() == 1 for v in tree.values())
    again = tiny_run("gmm4x.serve.gop").weights()
    assert all(torch.equal(tree[k], again[k]) for k in tree)


def test_4x_encode_and_decode_agree():
    r = tiny_run("gmm4x.serve.gop")
    net, tree = _net(r)
    ref = R.Net(tree, r.cfg)
    x = torch.rand(1, 3, 32, 48, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, yr = net.encode(x)[0], ref.encode(x)
        assert (y - yr).abs().max() < TOL * max(1.0, float(yr.abs().max()))
        lr = R.quantize(yr[..., :3])
        eps = torch.randn(net.eps_shape(lr.shape), generator=torch.Generator().manual_seed(2))
        hr, hrr = net.decode(lr, eps=eps)[0], ref.decode(lr, eps)
    assert (hr - hrr).abs().max() < TOL * max(1.0, float(hrr.abs().max()))


def test_codec_tiles_agree_with_the_programs_eval():
    r = tiny_run("codec.uvg.test")
    net, tree = _net(r)
    ref = R.Net(tree, r.cfg)
    ev = r.cfg["val"]
    video = torch.rand(6, 32, 64, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        lr = CP.encode_lr(ref, video, ev["seg_len"], ev["divide_width_num"])
        tile = video[3:6, :, 32:][None]
        assert (net.encode(tile)[0][0, ..., :3] - lr[3:6, :, 16:]).abs().max() < TOL
        lr_dec, hr, bpp = CP.roundtrip(ref, video, r.cfg)
        t = lr_dec[0:3, 8:16, 16:32][None]
        assert (net.decode(t)[0][0] - hr[0:3, 16:32, 32:64]).abs().max() < TOL


def test_zlib_copy_matches_the_programs_stand_in():
    from selfc_tpu_torch.codec.standin import ZlibCodec

    frames = np.random.default_rng(4).random((5, 16, 24, 3)).astype(np.float32)
    c = ZlibCodec(9, -1, 2)
    c.open_writer(24, 16)
    c.write_multi_frames(frames)
    bpp = c.close_writer()
    c.open_reader()
    dec = c.read_multi_frames(5)
    mine, mine_bpp = zlib_codec.roundtrip(frames, 9, -1, 2)
    assert mine_bpp == bpp and np.array_equal(mine, dec)
    lo, hi = zlib_codec.levels_of(np.rint(mine * 255).astype(np.uint8), zlib_codec.q_to_step(9))
    u8 = (np.clip(frames, 0, 1) * 255).round()
    assert (lo <= u8).all() and (u8 <= hi).all()


def test_bd_target_agrees():
    from selfc_tpu_torch.ops.resize import gaussian_downsample

    x = torch.rand(2, 3, 48, 48, 3, generator=torch.Generator().manual_seed(5))
    assert (gaussian_downsample(x, 4) - R.bd_downsample(x, 4)).abs().max() < TOL


def test_training_step_agrees():
    from selfc_tpu_torch.train.rescale_model import RescaleModel

    r = tiny_run("gmm4x.train.b8")
    cfg = r.cfg
    opt = dict_to_nonedict({"model": cfg["model"], "scale": 4, "distortion": "sr_bd", "is_train": True,
                            "datasets": {"train": {"video_len": 3, "batch_size": 2, "GT_size": 16}},
                            "network_G": cfg["network_G"], "train": cfg["train"]})
    model = RescaleModel(opt, device="cpu")
    tree = r.weights()
    model.load_jax_params(tree)
    tr = R.Trainer(tree, cfg, cfg["train"])
    g = torch.Generator().manual_seed(6)
    for step in range(2):
        hr = torch.rand(2, 3, 16, 16, 3, generator=g)
        eps = torch.randn(2, 3, 4, 4, 48, 5, generator=g)
        model.feed_data({"GT": hr.numpy()})
        model.optimize_parameters(step, eps=eps)
        loss, _ = tr.step(hr, eps)
        assert abs(model.get_current_log()["loss"] - loss) <= 1e-5 * abs(loss)
    # Adam scales each element's step to about lr (1e-4) whatever its gradient, so an
    # element whose gradient is near zero moves on rounding alone: a tenth of a step
    for n, p in model.net.named_parameters():
        assert (p.detach() - tr.params[n].detach()).abs().max() < 1e-5, n
