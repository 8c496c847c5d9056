"""The Haar-pyramid nets of the port against the JAX package, fp32, on the
CPU: the Haar ops, ``STPNetSmall``, ``SelfCNetHaar`` (model type 'SelfC')
and ``InvRescaleNet`` (model type 'IRN'), their factory entries and ``.pth``
key rules, one ``RescaleModel(model: SelfC)`` training step, and the
coupling's log-jacobian on images and videos.

Parity is checked on a fed ``eps`` / ``hf``, never on a seed: the two
stacks' random generators give different numbers from the same seed. The
JAX side runs jitted (one program a fixture): eager flax ``apply`` of these
nets costs tens of seconds on the CPU.

Tolerances: the Haar ops exactly; the prior 1e-5; the nets' outputs 1e-4
(abs); a training step's loss 1e-5 relative, its gradient tree 1e-4
relative l2; the quantised ``lr`` exactly, except where ``lr_pre_quant *
255`` lies within 1e-3 of a half-integer (there the last bit decides the
level).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.config import dict_to_nonedict as jnonedict
from selfc_tpu.models import factory as jfactory
from selfc_tpu.models.inv_nets import InvRescaleNet as JInvRescaleNet
from selfc_tpu.models.inv_nets import SelfCNetHaar as JSelfCNetHaar
from selfc_tpu.models.stp import STPNetSmall as JSTPNetSmall
from selfc_tpu.ops import gmm as jgmm
from selfc_tpu.ops import haar as jhaar
from selfc_tpu.ops import resize as jresize
from selfc_tpu.train.rescale_model import RescaleModel as JRescaleModel
from selfc_tpu.utils import torch_import as jti
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models import define_G
from selfc_tpu_torch.models.blocks import subnet
from selfc_tpu_torch.models.coupling import InvBlockExp
from selfc_tpu_torch.models.inv_nets import InvRescaleNet, SelfCNetHaar
from selfc_tpu_torch.models.stp import STPNetSmall
from selfc_tpu_torch.ops import haar
from selfc_tpu_torch.train.rescale_model import RescaleModel
from selfc_tpu_torch.utils import torch_import as tti
from selfc_tpu_torch.utils.jax_import import export_jax_grads, flatten_tree, load_jax_params, nest_tree
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


ATOL = 1e-4
CLIP = (1, 3, 32, 32, 3)
IMAGE = (2, 32, 32, 3)
TRAIN = {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "weight_decay_G": 0.0,
         "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1",
         "lambda_fit_forw": 1, "lambda_rec_back": 1, "lambda_cond_prob": 0.01}


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _fed(fn, value):
    """Run ``fn`` with the JAX package's normal draw replaced by ``value``."""
    saved = jgmm.sample_normal
    jgmm.sample_normal = lambda rng, shape, dtype: value.astype(dtype)
    try:
        return fn()
    finally:
        jgmm.sample_normal = saved


# ---------------------------------------------------------------------------
# the Haar ops
# ---------------------------------------------------------------------------


def test_haar_ops_match_jax_exactly():
    """On an image and on a video: the forward and the inverse the same
    bits as JAX's, the inverse of the forward the input, the log-jacobians
    equal."""
    for shape in ((2, 8, 12, 3), (1, 3, 8, 4, 12)):
        x = np.random.default_rng(0).normal(0, 1, shape).astype(np.float32)
        fwd = haar.haar_forward(torch.from_numpy(x))
        np.testing.assert_array_equal(fwd.numpy(), np.asarray(jhaar.haar_forward(jnp.asarray(x))))
        y = np.random.default_rng(1).normal(0, 1, fwd.shape).astype(np.float32)
        np.testing.assert_array_equal(haar.haar_inverse(torch.from_numpy(y)).numpy(),
                                      np.asarray(jhaar.haar_inverse(jnp.asarray(y))))
        np.testing.assert_allclose(haar.haar_inverse(fwd).numpy(), x, rtol=0, atol=1e-6)
        for rev in (False, True):
            assert haar.haar_log_jacobian(shape, rev) == jhaar.haar_log_jacobian(shape, rev)


# ---------------------------------------------------------------------------
# the Haar net's prior
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("condition", ["D2DTNet", "FeatureCollapse"])
@pytest.mark.parametrize("fh_loss", ["l2", "gmm"])
def test_stp_net_small_matches_jax(condition, fh_loss):
    lr = _rand(1, (1, 3, 8, 8, 3))
    kw = dict(stp_temporal_c=16, fh_loss=fh_loss, gmm_k=3, condition_func=condition, hf_dim=9)
    jm = JSTPNetSmall(**kw)
    tree = seeded_tree(jm, 2, jnp.asarray(lr))
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(tree, jnp.asarray(lr))
    tm = STPNetSmall(**kw)
    load_jax_params(tm, tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(lr))
    assert got.shape == (1, 3, 8, 8, 9 if fh_loss == "l2" else 81)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# SelfCNetHaar
# ---------------------------------------------------------------------------


def _tree_for(net, seed):
    """Seeded parameters in the JAX package's tree for the port's ``net``
    (whose names and shapes are the JAX net's: the factory test holds them
    to ``jax.eval_shape``), filled as ``test_torch_models.seeded_tree``
    fills them: fan-in scaled normal weights, N(0, 0.05) biases."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, p in net.named_parameters():
        std = 0.05 if p.dim() == 1 else float(np.prod(p.shape[:-1])) ** -0.5
        flat[k] = rng.normal(0, std, tuple(p.shape)).astype(np.float32)
    return nest_tree(flat)


def _model_opt(model="SelfC", scale=2, block_num=(1,), **top):
    return {"model": model, "scale": scale, "distortion": "sr_bd", "is_train": True,
            "network_G": {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": list(block_num)},
            "train": TRAIN, **top}


HAAR_CASES = {2: ((1,), (2, 3, 16, 16, 3)), 4: ((1, 1), (1, 3, 32, 32, 3))}


@functools.lru_cache(maxsize=None)
def _haar_stacks(scale):
    """Both stacks from the same parameters, clip and noise: encode and
    roundtrip; at 2x also one training step, the port's through its
    ``RescaleModel``, JAX's as ``jax.value_and_grad`` of the JAX
    ``RescaleModel._loss`` (its loss assembly, on a wrapper built without
    its init) with the roundtrip's outputs as aux: one JAX program a scale."""
    block_num, shape = HAAR_CASES[scale]
    train = scale == 2
    x = _rand(0, shape)
    model = RescaleModel(dict_to_nonedict(_model_opt(scale=scale, block_num=block_num)), device="cpu")
    tm = model.net
    tree = _tree_for(tm, 1)
    model.load_jax_params(tree)
    lat = shape[:2] + (shape[2] // scale, shape[3] // scale)
    eps = np.random.default_rng(4).normal(0, 1, tm.eps_shape(lat + (3,))).astype(np.float32)
    jm = JSelfCNetHaar(scale=scale, block_num=block_num)
    jrm = object.__new__(JRescaleModel)
    jrm.net, jrm.train_opt = jm, jnonedict(TRAIN)
    hr = jnp.asarray(x)
    ref_l = jresize.gaussian_downsample(hr, scale)

    def run(p, e):
        loss, logs, rt = _fed(lambda: jrm._pixel_losses(p, hr, ref_l, jax.random.PRNGKey(0)), e)
        return loss, (logs, rt, jm.apply({"params": p}, hr, method=jm.encode))

    fn = jax.value_and_grad(run, has_aux=True) if train else run
    out = jax.tree.map(np.asarray, jax.jit(fn)(tree, jnp.asarray(eps)))
    (_, (logs, rt, (y, jac))), grads = out if train else (out, None)
    want = {"y": y, "jac": jac, "rt": rt, "logs": logs, "grads": grads and flatten_tree(grads)}
    with torch.no_grad():
        t = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
        y, jac = tm.encode(t(x))
        got = {"y": y, "jac": jac, "fwd": tm(t(x)), "rt": tm.roundtrip(t(x), eps=t(eps)),
               "nll": tm.nll(t(rt["lr_pre_quant"]), t(want["y"][..., 3:])),
               "hr": tm.decode(t(rt["lr"]), eps=t(eps))[0]}
    if train:
        assert model.feed_data({"GT": x}) == 3
        model.optimize_parameters(0, eps=eps)
        got["logs"], got["grads"] = dict(model.get_current_log()), flatten_tree(export_jax_grads(model.net))
    return tm, x, eps, want, got


@pytest.fixture(scope="module", params=sorted(HAAR_CASES), ids=["x2", "x4"])
def haar_pair(request):
    return _haar_stacks(request.param)


@pytest.fixture(scope="module")
def train_pair():
    return _haar_stacks(2)


def test_selfc_haar_encode_and_nll_match_jax(haar_pair):
    """The latent and its log-jacobian; the conditional NLL of the true HF
    (JAX's roundtrip ``loss_c``), on JAX's latents and through the forward
    on the port's."""
    tm, x, _, want, got = haar_pair
    assert got["y"].shape == x.shape[:2] + (x.shape[2] // tm.scale, x.shape[3] // tm.scale, 3 * tm.scale ** 2)
    np.testing.assert_allclose(got["y"].numpy(), want["y"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(got["jac"]), float(want["jac"]), rtol=1e-5)
    np.testing.assert_allclose(got["fwd"][0].numpy(), want["y"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(got["nll"]), float(want["rt"]["loss_c"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["fwd"][1]), float(want["rt"]["loss_c"]), rtol=1e-5)


def test_selfc_haar_decode_on_fed_eps_matches_jax(haar_pair):
    """The port's decode of JAX's quantised LR with the same eps (the GMM
    sample with std exp(0.5 log-scale), the inverse pyramid)."""
    _, x, _, want, got = haar_pair
    assert got["hr"].shape == x.shape
    np.testing.assert_allclose(got["hr"].numpy(), want["rt"]["hr"], rtol=0, atol=ATOL)


def test_selfc_haar_roundtrip_matches_jax(haar_pair):
    _, x, _, want, got = haar_pair
    rt, rt_j = got["rt"], want["rt"]
    pre = rt_j["lr_pre_quant"]
    np.testing.assert_allclose(rt["lr_pre_quant"].numpy(), pre, rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(rt["loss_c"]), float(rt_j["loss_c"]), rtol=1e-5)
    safe = np.abs((np.clip(pre, 0, 1) * 255) % 1 - 0.5) > 1e-3
    assert safe.mean() > 0.95
    # the same 255-level quantisation where no last bit decides the level
    np.testing.assert_array_equal(np.round(rt["lr"].numpy() * 255)[safe], np.round(rt_j["lr"] * 255)[safe])
    if np.array_equal(np.round(rt["lr"].numpy() * 255), np.round(rt_j["lr"] * 255)):
        np.testing.assert_allclose(rt["hr"].numpy(), rt_j["hr"], rtol=0, atol=ATOL)
    assert rt["hr"].shape == x.shape


def test_selfc_haar_decode_with_hf_inverts_encode(haar_pair):
    tm, x, _, _, _ = haar_pair
    with torch.no_grad():
        y, _ = tm.encode(torch.from_numpy(x))
        back, _ = tm.decode_with_hf(y[..., :3], y[..., 3:])
        again, _ = tm.decode(y[..., :3].contiguous(), generator=torch.Generator().manual_seed(3))
        same, _ = tm.decode(y[..., :3].contiguous(), generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5)
    assert torch.equal(again, same)


def test_selfc_train_step_matches_jax(train_pair):
    """The step's losses (1e-5 relative) and its whole gradient (1e-4
    relative l2) against the JAX ``_loss`` and ``jax.value_and_grad``."""
    want, got = train_pair[3]["logs"], train_pair[4]["logs"]
    assert got["skipped_nonfinite"] == 0.0 and got["loss_c"] != 0.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=k)
    want, got = train_pair[3]["grads"], train_pair[4]["grads"]
    assert set(got) == set(want)
    num = sum(((got[k] - v).astype(np.float64) ** 2).sum() for k, v in want.items())
    den = sum((v.astype(np.float64) ** 2).sum() for v in want.values())
    assert (num / den) ** 0.5 <= 1e-4
    assert all(np.abs(got[k]).max() > 0 for k in want if ".chain.conv" in k)


# ---------------------------------------------------------------------------
# InvRescaleNet and the coupling's log-jacobian
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def irn_pair():
    """Both stacks' encode of a batch of images, decode of a fed (lr, hf)
    and forward, from the same parameters."""
    x = _rand(5, IMAGE)
    jm = JInvRescaleNet(scale=4, block_num=(1, 1))
    tree = seeded_tree(jm, 6, jnp.asarray(x))
    tm = InvRescaleNet(scale=4, block_num=(1, 1), device="cpu")
    load_jax_params(tm, tree)
    lr = _rand(7, (2, 8, 8, 3))
    hf = _rand(8, (2, 8, 8, tm.hf_dim))

    def run(p, x, lr, hf):
        ap = lambda *a, **kw: jm.apply({"params": p}, *a, **kw)  # noqa: E731
        saved = jax.random.uniform
        jax.random.uniform = lambda key, shape, dtype: hf.astype(dtype)
        try:
            dec = ap(lr, method=jm.decode, rngs={"sample": jax.random.PRNGKey(0)})
        finally:
            jax.random.uniform = saved
        return {"enc": ap(x, method=jm.encode), "hr": dec[0], "fwd": ap(x)}

    want = jax.tree.map(np.asarray, jax.jit(run)(tree, *(jnp.asarray(v) for v in (x, lr, hf))))
    with torch.no_grad():
        t = lambda v: torch.from_numpy(v)  # noqa: E731
        got = {"enc": tm.encode(t(x)), "hr": tm.decode(t(lr), hf=t(hf))[0], "fwd": tm(t(x))}
    return tm, x, lr, want, got


def test_irn_encode_and_forward_match_jax(irn_pair):
    _, _, _, want, got = irn_pair
    assert got["enc"][0].shape == (2, 8, 8, 48)
    np.testing.assert_allclose(got["enc"][0].numpy(), want["enc"][0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["fwd"][0].numpy(), want["fwd"][0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(got["fwd"][1]), float(want["fwd"][1]), rtol=1e-5)


def test_irn_log_jacobian_matches_jax(irn_pair):
    """The coupling divides an image's log-jacobian by B (a video's by
    B*T), as the JAX package does."""
    _, _, _, want, got = irn_pair
    np.testing.assert_allclose(float(got["enc"][1]), float(want["enc"][1]), rtol=1e-5)


def test_irn_decode_matches_jax_inverts_and_draws_uniform_hf(irn_pair):
    """Decode of a fed HF against JAX's; with the true HF the input back;
    without one, U[0,1) HF from a generator (or a refusal)."""
    tm, x, lr, want, got = irn_pair
    assert got["hr"].shape == IMAGE
    np.testing.assert_allclose(got["hr"].numpy(), want["hr"], rtol=0, atol=ATOL)
    y = got["enc"][0]
    with torch.no_grad():
        back, _ = tm.decode(y[..., :3].contiguous(), hf=y[..., 3:].contiguous())
        a, hf_a = tm.decode(torch.from_numpy(lr), generator=torch.Generator().manual_seed(1))
        b, _ = tm.decode(torch.from_numpy(lr), generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5)
    assert torch.equal(a, b) and hf_a.shape == (2, 8, 8, 45)
    assert 0 <= hf_a.min() and hf_a.max() < 1
    with pytest.raises(ValueError):
        tm.decode(torch.from_numpy(lr))


@pytest.mark.parametrize("subnet_type", ["D2DTNet", "D2DNet"], ids=["fused", "plain"])
def test_video_coupling_log_jacobian_unchanged(subnet_type):
    """On a video the log-jacobian is sum(log exp(s)) (fused epilogues) or
    sum(s) (the plain branch) over B*T, bit for bit as before the image
    case was repaired."""
    torch.manual_seed(0)
    blk = InvBlockExp(12, 3, subnet(subnet_type), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0, 0.1)
        x1, x2 = torch.rand(2, 3, 8, 8, 3), torch.rand(2, 3, 8, 8, 9)
        (y1, _), jac = blk((x1, x2), False)
        if subnet_type == "D2DTNet":
            s = torch.log(blk.H(y1, ep=("sig_exp", blk.clamp, None, None)))
        else:
            s = blk.clamp * (2.0 * torch.sigmoid(blk.H(y1)) - 1.0)
    assert blk.use_ep == (subnet_type == "D2DTNet")
    assert torch.equal(jac, torch.sum(s) / (x1.shape[0] * x1.shape[1]))


# ---------------------------------------------------------------------------
# the factory, the parameter counts, the .pth key rules
# ---------------------------------------------------------------------------


def _net_opt(model, scale=4, block_num=(1, 1), subnet_type=None):
    which = {"subnet_type": subnet_type} if subnet_type else {}
    return {"model": model, "scale": scale,
            "network_G": {"which_model_G": which, "block_num": list(block_num), "scale": scale}}


_JAX_SHAPES = {}


def _jax_shapes(model, net):
    """The JAX net's parameter names and shapes, from ``jax.eval_shape`` of
    its init (which computes nothing), once a net class."""
    key = type(net).__name__
    if key not in _JAX_SHAPES:
        image = isinstance(net, JInvRescaleNet)
        x = jnp.zeros((1, 16, 16, 3) if image else (1, 3, 16, 16, 3))
        keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
        kw = {} if image else {"method": net.roundtrip}
        shapes = jax.eval_shape(lambda: net.init(keys, x, **kw))["params"]
        _JAX_SHAPES[key] = {k: tuple(v.shape) for k, v in flatten_tree(shapes).items()}
    return _JAX_SHAPES[key]


@pytest.mark.parametrize("model,subnet_type", [("SelfC", None), ("SelfC_shell", None),
                                               ("IRN", "DBNet"), ("IRN_Contra_UP", "DBNet")])
def test_factory_builds_the_haar_nets_with_jax_names(model, subnet_type):
    opt = _net_opt(model, subnet_type=subnet_type)
    want = _jax_shapes(model, jfactory.define_G(jnonedict(opt)))
    net = define_G(dict_to_nonedict(opt), device="cpu")
    assert isinstance(net, InvRescaleNet if model.startswith("IRN") else SelfCNetHaar)
    assert {k: tuple(p.shape) for k, p in net.named_parameters()} == want


def test_full_width_parameter_counts():
    """SelfC 4x with the factory's defaults, and IRN x4 at the upstream IRN
    repo's widths: the JAX package's counts."""
    for model, block_num, subnet_type, n in (("SelfC", (4, 4), None, 2_215_699),
                                             ("IRN", (8, 8), "DBNet", 4_355_136)):
        net = define_G(dict_to_nonedict(_net_opt(model, 4, block_num, subnet_type)), device="cpu")
        assert sum(p.numel() for p in net.parameters()) == n, model


def _reference_key(name, block_num):
    """The reference state-dict key of a Haar / IRN tree path
    (``map_reference_key``'s inverse)."""
    p = name.split(".")
    if p[0].startswith("level_blocks_"):
        level, i = (int(v) for v in p[0].split("_")[2:])
        idx = 1 + sum(block_num[:level]) + level + i
        return f"operations.{idx}.{p[1]}.{p[3]}.{p[4]}"
    if p[1].startswith("tail_"):
        return f"stp_net.tail.{2 * int(p[1][5:]) + 1}.{p[2]}"
    blk = "blk1." + p[1][5:] if p[1].startswith("blk1_") else p[1]
    return f"stp_net.{blk}.{p[3]}.{p[4]}"


def _torch_shape(shape, image):
    """A reference tensor's shape for a tree leaf: Conv2d for the IRN's
    convs, Conv3d (1,3,3), (3,1,1) and (1,1,1) for the video net's."""
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1]) if image else (shape[3], shape[2], 1, shape[0], shape[1])
    if len(shape) == 3:
        return (shape[2], shape[1], shape[0], 1, 1)
    if len(shape) == 2:
        return (shape[1], shape[0], 1, 1, 1)
    return shape


@pytest.mark.parametrize("arch", ["haar", "irn"])
def test_pth_rules_match_jax(arch, tmp_path):
    """A reference ``.pth`` of each net, written by the JAX package's
    ``export_state_dict`` (keys under a DDP ``module.`` prefix, the Haar
    steps' fixed ``haar_weights`` among them): every key maps as the JAX
    package maps it, and ``load_pth`` gives the JAX import's tree, which is
    the exported one."""
    block_num = (1, 2)
    net = (SelfCNetHaar(scale=4, block_num=block_num, device="cpu") if arch == "haar"
           else InvRescaleNet(scale=4, block_num=block_num, subnet_type="DBNet", device="cpu"))
    tree = _tree_for(net, 9)
    template = {"module." + _reference_key(k, block_num): np.zeros(_torch_shape(v.shape, arch == "irn"), np.float32)
                for k, v in flatten_tree(tree).items()}
    for idx in (0, 1 + block_num[0]):
        template[f"module.operations.{idx}.haar_weights"] = np.ones((12, 1, 2, 2), np.float32)
    for k in template:
        assert tti.map_reference_key(k, arch, block_num) == jti.map_reference_key(k, arch, block_num), k
    sd = jti.export_state_dict(tree, template, arch, block_num)
    path = tmp_path / f"{arch}.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    got = flatten_tree(tti.load_pth(str(path), arch, block_num))
    for want in (flatten_tree(jti.import_state_dict(sd, arch, block_num)), flatten_tree(tree)):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


# ---------------------------------------------------------------------------
# RescaleModel: a SelfC training step, the IRN refusal
# ---------------------------------------------------------------------------


def test_rescale_model_serves_selfc_and_refuses_irn():
    net = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1]}
    model = RescaleModel(dict_to_nonedict({"model": "SelfC", "scale": 2, "network_G": net,
                                           "val": {"eval_dtype": "bfloat16"}}), device="cpu")
    clip = _rand(13, (1, 3, 16, 16, 3))
    model.feed_data({"GT": clip})
    model.test(gop=7)
    assert model.fake_H.shape == clip.shape and model.forw_H.shape == (1, 3, 8, 8, 9)
    assert np.isfinite(model.fake_H).all() and model.upscale(model.downscale(clip)).shape == clip.shape
    with pytest.raises(NotImplementedError, match="roundtrip"):
        RescaleModel(dict_to_nonedict(dict(_model_opt("IRN"), is_train=False)), device="cpu")
