"""The rest of the JAX package's modules in the port, against it, fp32, on
the CPU: ``network_G.remat`` and ``network_G.scan_blocks`` (the same loss
bits; a stacked ``scan_chain`` tree loads, and the net saves it stacked),
SpyNet (``MESpynet`` on random ``.npy`` weights, ``flow_warp``,
``resize_bilinear``, ``WarpNet``, ``motion_flow_loss``), the ``.pth`` export
(``export_state_dict`` on each architecture), the BPG bridge (its backend,
the HEVC-intra path, the stand-in), and the training steps' cuDNN flags.

Tolerances: a forward 1e-5 of the output's largest magnitude (at least 1);
an export or a checkpoint bit for bit.
"""

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.codec import bpg as jbpg
from selfc_tpu.codec import h265 as jh265
from selfc_tpu.models import spy_flow as jspy
from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
from selfc_tpu.utils import torch_import as jti
from selfc_tpu_torch.codec import bpg as tbpg
from selfc_tpu_torch.codec import h265 as th265
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models import spy_flow as tspy
from selfc_tpu_torch.models.inv_nets import InvRescaleNet, SelfCNetCodec, SelfCNetGMM, SelfCNetHaar
from selfc_tpu_torch.train import checkpoint as ckpt
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.train.rescale_model import RescaleModel
from selfc_tpu_torch.utils import torch_import as tti
from selfc_tpu_torch.utils.jax_import import (export_jax_grads, export_jax_params, flatten_tree, load_jax_params,
                                             nest_tree)
from test_torch_checkpoint import _reference_key as gmm_reference_key
from test_torch_checkpoint import _torch_shape as gmm_torch_shape
from test_torch_haar import _reference_key as haar_reference_key
from test_torch_haar import _torch_shape as haar_torch_shape
from test_torch_haar import _tree_for
from test_torch_models import seeded_tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# remat and scan_blocks
# ---------------------------------------------------------------------------


NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1, 1], "scale": 4, "stp_blk_num": 1,
       "gmm_k": 2}
TRAIN = {"lr_G": 1e-4, "gradient_clipping": 10, "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1"}


def _trainer(**net):
    opt = dict_to_nonedict({"model": "SelfC_GMM", "scale": 4, "is_train": True, "distortion": "sr_bd",
                            "network_G": dict(NET, **net), "train": dict(TRAIN)})
    return RescaleModel(opt, device="cpu")


@pytest.fixture(scope="module")
def remat_pair():
    """One step with ``remat`` false and true from the same parameters,
    clip and noise; each coupling block's forward calls counted."""
    x = _rand(1, (1, 3, 16, 16, 3))
    out = {}
    for remat in (False, True):
        model = _trainer(remat=remat)
        if not out:
            tree = _tree_for(model.net, 2)
            e = np.random.default_rng(3).normal(0, 1, model.net.eps_shape((1, 3, 4, 4, 3))).astype(np.float32)
        model.load_jax_params(tree)
        model.feed_data({"GT": x})
        calls = []
        model.net.inv_blocks_0.register_forward_pre_hook(lambda *a: calls.append(1))
        model.optimize_parameters(0, eps=e)
        out[remat] = (model, dict(model.get_current_log()), export_jax_grads(model.net), len(calls))
    return out


def test_remat_same_loss_and_gradient_bits(remat_pair):
    """``network_G.remat: true`` reruns each coupling block's forward in the
    backward (4 calls of block 0 a step, against 2: encode and decode) and
    gives the same loss and gradient bits."""
    (m0, log0, g0, calls0), (m1, log1, g1, calls1) = remat_pair[False], remat_pair[True]
    assert not m0.net.remat and m1.net.remat and (calls0, calls1) == (2, 4)
    assert log0 == log1
    for k, v in flatten_tree(g0).items():
        np.testing.assert_array_equal(flatten_tree(g1)[k], v, err_msg=k)
    for k, v in flatten_tree(export_jax_params(m0.net)).items():
        np.testing.assert_array_equal(flatten_tree(export_jax_params(m1.net))[k], v, err_msg=k)


def test_remat_off_outside_autograd(remat_pair):
    """Under ``no_grad`` (serving) a remat net runs each block once."""
    model = remat_pair[True][0]
    calls = []
    h = model.net.inv_blocks_1.register_forward_pre_hook(lambda *a: calls.append(1))
    model.feed_data({"GT": _rand(4, (1, 3, 16, 16, 3))})
    model.test(gop=7)
    h.remove()
    assert len(calls) == 2


def test_scan_blocks_stacked_tree_loads_and_saves(tmp_path):
    """A tree in the JAX ``scan_blocks`` layout (``stack_block_params``,
    the names and shapes of the JAX scan net's ``eval_shape``) loads into
    the port's ``scan_blocks`` net, through ``load_jax_params`` and a
    msgpack checkpoint, to the per-block net's function; the net's own
    checkpoint is written stacked again."""
    x = _rand(5, (1, 3, 16, 16, 3))
    plain = _trainer()
    tree = _tree_for(plain.net, 6)
    plain.load_jax_params(tree)
    stacked = jti.stack_block_params(tree, 2)
    jnet = JSelfCNetGMM(scale=4, block_num=(1, 1), stp_blk_num=1, gmm_k=2, scan_blocks=True)
    shapes = jax.eval_shape(lambda: jnet.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                                              jnp.asarray(x), method=jnet.roundtrip))["params"]
    assert {k: tuple(v.shape) for k, v in flatten_tree(stacked).items()} == \
        {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
    path = tmp_path / "5_G.msgpack"
    path.write_bytes(fser.msgpack_serialize(stacked))
    opt = dict_to_nonedict({"model": "SelfC_GMM", "scale": 4, "is_train": True, "distortion": "sr_bd",
                            "network_G": dict(NET, scan_blocks=True), "train": dict(TRAIN),
                            "path": {"pretrain_model_G": str(path), "models": str(tmp_path / "out")}})
    scan = RescaleModel(opt, device="cpu")
    assert scan.net.scan_blocks
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(flatten_tree(export_jax_params(scan.net))[k], v, err_msg=k)
    load_jax_params(scan.net, stacked)
    with torch.no_grad():
        for a, b in zip(scan.net.encode(torch.from_numpy(x)), plain.net.encode(torch.from_numpy(x))):
            assert torch.equal(a, b)
    saved = ckpt.read_msgpack(scan.save(9))
    assert set(saved) == set(shapes) and "scan_chain" in saved
    for k, v in flatten_tree(stacked).items():
        np.testing.assert_array_equal(flatten_tree(saved)[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# SpyNet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spynet(tmp_path_factory):
    """DVC-layout ``.npy`` weights (fan-in scaled normals), both stacks'
    MESpynet on them."""
    d = tmp_path_factory.mktemp("spynet")
    rng = np.random.default_rng(7)
    for lv in range(4):
        for ci, (cin, cout) in enumerate([(8, 32), (32, 64), (64, 32), (32, 16), (16, 2)], start=1):
            np.save(d / f"modelL{lv + 1}_F-{ci}-weight.npy",
                    rng.normal(0, (49 * cin) ** -0.5, (cout, cin, 7, 7)).astype(np.float32))
            np.save(d / f"modelL{lv + 1}_F-{ci}-bias.npy", rng.normal(0, 0.05, cout).astype(np.float32))
    jparams = jspy.load_spynet_npy(str(d))
    tparams = tspy.load_spynet_npy(str(d))
    net = tspy.MESpynet(device="cpu")
    load_jax_params(net, tparams)
    jnet = jspy.MESpynet()
    return net, jax.jit(lambda a, b: jnet.apply({"params": jparams}, a, b)), tparams, jparams


def test_spynet_npy_import_and_flow_match_jax(spynet):
    net, japply, tparams, jparams = spynet
    for k, v in flatten_tree(jparams).items():
        np.testing.assert_array_equal(flatten_tree(tparams)[k], np.asarray(v), err_msg=k)
    a, b = _rand(8, (1, 32, 32, 3)), _rand(9, (1, 32, 32, 3))
    with torch.no_grad():
        got = net(torch.from_numpy(a), torch.from_numpy(b))
    want = japply(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (1, 32, 32, 2) and np.abs(np.asarray(want)).max() > 0.1
    _close(got, want)
    with pytest.raises(ValueError, match="H,W >= 16"):
        net(torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 8, 3))


def test_motion_flow_loss_matches_jax(spynet):
    net, japply, _, _ = spynet
    hr1, hr2 = _rand(10, (1, 64, 64, 3)), _rand(11, (1, 64, 64, 3))
    lr1, lr2 = _rand(12, (1, 16, 16, 3)), _rand(13, (1, 16, 16, 3))
    with torch.no_grad():
        got = tspy.motion_flow_loss(net, tuple(map(torch.from_numpy, (lr1, lr2))),
                                    tuple(map(torch.from_numpy, (hr1, hr2))), scale=4).item()
    want = float(jspy.motion_flow_loss(japply, tuple(map(jnp.asarray, (lr1, lr2))),
                                       tuple(map(jnp.asarray, (hr1, hr2))), scale=4))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


@pytest.mark.parametrize("align_corners", [False, True])
def test_warp_and_resize_match_jax(align_corners):
    """``flow_warp`` with flows past the border (clamped taps), and
    ``resize_bilinear`` up and down."""
    rng = np.random.default_rng(14)
    img = rng.random((2, 9, 13, 3), dtype=np.float32)
    flow = rng.normal(0, 4, (2, 9, 13, 2)).astype(np.float32)
    _close(tspy.flow_warp(torch.from_numpy(img), torch.from_numpy(flow)), jspy.flow_warp(img, flow))
    for hw in ((18, 26), (5, 7)):
        _close(tspy.resize_bilinear(torch.from_numpy(img), hw, align_corners),
               jspy.resize_bilinear(jnp.asarray(img), hw, align_corners))


def test_warp_net_matches_jax():
    x = _rand(15, (1, 16, 16, 6))
    jnet = jspy.WarpNet()
    tree = seeded_tree(jnet, 16, jnp.asarray(x))
    net = tspy.WarpNet(device="cpu")
    load_jax_params(net, tree)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _close(got, jax.jit(jnet.apply)({"params": tree}, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# the .pth export
# ---------------------------------------------------------------------------


def _net_and_template(arch):
    block_num = {"gmm": (1, 1), "codec": (1,), "haar": (1, 2), "irn": (1, 2)}[arch]
    if arch == "gmm":
        net = SelfCNetGMM(scale=4, block_num=block_num, stp_blk_num=3, gmm_k=2, device="cpu")
    elif arch == "codec":
        net = SelfCNetCodec(scale=2, block_num=block_num, stp_blk_num=2, deart_net=True, device="cpu")
    elif arch == "haar":
        net = SelfCNetHaar(scale=4, block_num=block_num, device="cpu")
    else:
        net = InvRescaleNet(scale=4, block_num=block_num, subnet_type="DBNet", device="cpu")
    tree = _tree_for(net, 17)
    if arch in ("gmm", "codec"):
        template = {"module." + gmm_reference_key(k): torch.zeros(gmm_torch_shape(v.shape))
                    for k, v in flatten_tree(tree).items()}
        template["module.Quantization_H265_Suggrogate.conv.weight"] = torch.ones(2, 3)
    else:
        template = {"module." + haar_reference_key(k, block_num): torch.zeros(haar_torch_shape(v.shape, arch == "irn"))
                    for k, v in flatten_tree(tree).items()}
        for idx in (0, 1 + block_num[0]):
            template[f"module.operations.{idx}.haar_weights"] = torch.ones(12, 1, 2, 2)
    return net, tree, template, block_num


@pytest.mark.parametrize("arch", ["gmm", "codec", "haar", "irn"])
def test_export_state_dict_matches_jax(arch):
    """The port's export of a net's tree (numpy leaves, and the net's own
    tensors) into a reference state dict (torch template, the skipped keys
    passed through) is the JAX package's bit for bit, and imports back to
    the tree; a template shape the tree cannot fill raises."""
    net, tree, template, block_num = _net_and_template(arch)
    want = jti.export_state_dict(tree, {k: v.numpy() for k, v in template.items()}, arch, block_num)
    load_jax_params(net, tree)
    own = nest_tree(dict(net.named_parameters()))
    for got in (tti.export_state_dict(tree, template, arch, block_num),
                tti.export_state_dict(own, template, arch, block_num)):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = flatten_tree(tti.import_state_dict(want, arch, block_num))
    for k, v in flatten_tree(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    bad = dict(template)
    key = next(k for k in bad if "haar_weights" not in k and "Suggrogate" not in k and bad[k].dim() > 1)
    bad[key] = torch.zeros((bad[key].shape[0] + 1,) + tuple(bad[key].shape[1:]))
    with pytest.raises(ValueError, match="exported shape"):
        tti.export_state_dict(tree, bad, arch, block_num)


# ---------------------------------------------------------------------------
# BPG
# ---------------------------------------------------------------------------


def _smooth_frames():
    rng = np.random.default_rng(18)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64.0
    base = np.stack([yy, xx, 0.5 * (xx + yy)], axis=-1)
    return np.clip(base[None] + 0.02 * rng.standard_normal((2, 64, 64, 3)), 0, 1).astype(np.float32)


def test_bpg_backend_and_hevc_intra_match_jax():
    """Without ``bpgenc`` the backend is the JAX package's; through the
    HEVC-intra path (each frame its own all-intra x265 stream) the decoded
    frames and the measured rate are the JAX bridge's, and a higher q gives
    a lower rate and more distortion."""
    backend = tbpg.bpg_backend()
    assert not tbpg.bpg_available() and backend == jbpg.bpg_backend()
    if backend != "hevc-intra":
        pytest.skip("no x265 on this host: the HEVC-intra path cannot run")
    x = _smooth_frames()
    out = {}
    for q in (20, 35):
        dec, bpp = tbpg.bpg_roundtrip(x, q=q)
        jdec, jbpp = jbpg.bpg_roundtrip(x, q=q)
        np.testing.assert_array_equal(dec, jdec)
        assert bpp == jbpp
        out[q] = (float(((dec - x) ** 2).mean()), bpp)
    assert out[20][1] > out[35][1] > 0 and out[20][0] < out[35][0] < 5e-3


def test_bpg_standin_without_a_codec_matches_jax(monkeypatch):
    """With no ``bpgenc`` and no x265 (the card's machine has neither) the
    backend is None and the 8-bit stand-in gives the JAX package's frames and
    formula rate."""
    monkeypatch.setattr(th265, "codec_backend", lambda: None)
    monkeypatch.setattr(jh265, "codec_backend", lambda: None)
    assert tbpg.bpg_backend() is None and jbpg.bpg_backend() is None
    x = _smooth_frames()
    for q in (12, 29):
        dec, bpp = tbpg.bpg_roundtrip(x, q=q)
        jdec, jbpp = jbpg.bpg_roundtrip(x, q=q)
        np.testing.assert_array_equal(dec, jdec)
        assert bpp == jbpp


# ---------------------------------------------------------------------------
# the training steps' cuDNN flags
# ---------------------------------------------------------------------------


def test_training_steps_run_under_deterministic_cudnn(remat_pair, monkeypatch):
    """Both wrappers' steps (the codec's pipelined retire too) run with
    cuDNN's deterministic algorithms and no autotuning, and put the caller's
    flags back; ``cudnn_deterministic = False`` leaves the caller's."""
    cudnn = torch.backends.cudnn
    seen = []

    def record(*a, **kw):
        seen.append((cudnn.deterministic, cudnn.benchmark))

    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    model = remat_pair[False][0]
    monkeypatch.setattr(model, "_optimize", record)
    model.optimize_parameters(1)
    codec = object.__new__(CodecModel)
    codec.is_train, codec.cudnn_deterministic = True, True
    codec._pending = {"batch": 1}
    monkeypatch.setattr(codec, "_optimize", record, raising=False)
    monkeypatch.setattr(codec, "_retire", record, raising=False)
    codec.optimize_parameters(1)
    codec.flush_pipeline()
    assert seen == [(True, False)] * 3
    assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    model.cudnn_deterministic = False
    try:
        model.optimize_parameters(1)
    finally:
        model.cudnn_deterministic = True
    assert seen[-1] == (False, True)
