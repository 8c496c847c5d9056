"""The device mesh of the port (``selfc_tpu_torch/parallel/mesh.py``) and the
two paths that use it, on meshes of repeated ``"cpu"`` devices: the image
width split of SelfC_GMM (``parallel/spatial.py``, ``mesh_sp``) in the
training step and ``test()``, and the eval split over the dp rows of both
model wrappers. The net is the JAX package's own sp test's
(``tests/test_spatial_parallel.py``): ``block_num [1, 1]``, ``stp_blk_num 2``,
``gmm_k 2``, W 64. The codec and Haar nets' split: ``tests/test_torch_mesh_nets.py``.

Tolerances:
- split against unsplit in the port: forwards the same bits on the CPU (a
  haloed chain computes each output pixel as the unsplit one does; the split
  pool within 1e-6), the halo's and the pool's adjoints (dx, dW) within 1e-6
  of max |ref| (the halo's gradient adds into its columns in another order);
  in the step, the loss
  within 1e-6 relative; every gradient leaf within 1e-6 relative l2, but the
  attention's leaves of ``GlobalAgg`` (``fc``, ``proj2``, ``proj3``: their
  gradients, 1e-7 of the largest leaf's, are sums that cancel) within 1e-5
  (the pool's sums are added by shards: the last bits of the pooled map
  differ); ``proj3_b``'s gradient is zero by construction and holds
  rounding noise: left out;
- the bf16 (``mixed_precision``) split step against the unsplit bf16 step:
  the loss within 5e-5 relative, every gradient leaf within 1e-2 relative
  l2, the attention's within 5e-2 (a haloed shard is another shape, so a
  bf16 output may round one ulp, 4e-3, the other way; the split moves the
  gradients ~0.4%, the attention's ~2%, where bf16 against fp32 moves them
  up to 23%);
- the sp 2 step against the JAX package's unsplit function: as
  ``test_torch_train.py`` holds the unsplit step (loss rtol 1e-5, each
  gradient leaf 1e-3 of its largest element), the roundtrip's outputs 1e-4;
- dp 2 ``test()`` against dp 1: the same bits, for both wrappers.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
from selfc_tpu.ops import gmm as jgmm
from selfc_tpu.ops import resize as jresize
from selfc_tpu.train import losses as jlosses
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.kernels import build
from selfc_tpu_torch.models.agg import GlobalAgg
from selfc_tpu_torch.models.blocks import D2DT
from selfc_tpu_torch.ops import chain_variants, deform, dense_chain, temporal_conv
from selfc_tpu_torch.ops.resize import gaussian_downsample
from selfc_tpu_torch.parallel import mesh as pm
from selfc_tpu_torch.parallel import spatial
from selfc_tpu_torch.parallel.spatial import HALO, WidthSplitGMM, gaussian_downsample_shards
from selfc_tpu_torch.train import create_model
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.train.rescale_model import RescaleModel
from selfc_tpu_torch.utils.jax_import import export_jax_grads, flatten_tree
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


NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1, 1], "scale": 4, "init": "xavier",
       "global_module": "nonlocal", "stp_blk_num": 2, "fh_loss": "gmm", "gmm_k": 2}
TRAIN = {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "lr_scheme": "MultiStepLR", "lr_steps": [],
         "lr_gamma": 0.5, "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1",
         "lambda_fit_forw": 1, "lambda_rec_back": 1, "lambda_cond_prob": 0, "gradient_clipping": 10}
CLIP = (2, 3, 32, 64, 3)
EPS = (2, 3, 8, 16, 48, 2)
ATTENTION = (".fc_", ".proj2_", ".proj3_w")


def _opt(sp=1, model="SelfC_GMM", is_train=True, network=None, train=None, **val):
    return dict_to_nonedict({
        "is_train": is_train, "model": model, "distortion": "sr_bd", "scale": 4, "mesh_sp": sp,
        "datasets": {"train": {"video_len": 3, "GT_size": 32}}, "val": val,
        "network_G": dict(NET, **(network or {})), "path": {}, "train": dict(TRAIN, **(train or {}))})


def _cpus(dp, sp):
    return pm.make_mesh(dp=dp, sp=sp, devices=["cpu"] * (dp * sp))


def _close(got, want, rel):
    """``got`` within ``rel`` of max |want| everywhere."""
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), (err, want.abs().max().item())


def _rand(seed, shape, normal=False):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) if normal else rng.random(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def stacks():
    """(JAX module, its seeded parameter tree, clip, eps)."""
    x = _rand(0, CLIP)
    jm = JSelfCNetGMM(scale=4, block_num=(1, 1), stp_blk_num=2, gmm_k=2)
    tree = seeded_tree(jm, 1, jnp.asarray(x), method=jm.roundtrip)
    return jm, tree, x, _rand(2, EPS, normal=True)


def _stepped(tree, x, eps, mesh, network=None, train=None):
    model = RescaleModel(_opt(mesh.sp, network=network, train=train), device="cpu", mesh=mesh)
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, eps=eps)
    logs = dict(model.get_current_log())
    return logs, {k: p.grad.clone() for k, p in model.net.named_parameters()}, model


@pytest.fixture(scope="module")
def unsplit_step(stacks):
    _, tree, x, eps = stacks
    return _stepped(tree, x, eps, _cpus(1, 1))


# ---------------------------------------------------------------------------
# the mesh and its moves
# ---------------------------------------------------------------------------


def test_make_mesh_grid_and_its_errors(monkeypatch):
    m = pm.make_mesh(sp=2, devices=["cpu"] * 4)
    assert m.shape == {"dp": 2, "sp": 2} and m.cards() == 1
    assert m.master == torch.device("cpu") and m.devices[1][1] == torch.device("cpu")
    with pytest.raises(ValueError, match="device count"):
        pm.make_mesh(dp=2, sp=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="device count"):
        pm.make_mesh(sp=2, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh()
    # one named device builds no mesh of several cards: it is one card
    with pytest.raises(ValueError, match="device count"):
        pm.model_mesh("cuda:1", sp=2)
    assert pm.model_mesh("cpu", sp=2).shape == {"dp": 1, "sp": 2}
    # alone, a process owns every card it sees; under torchrun, rank r owns
    # the sp cards from r * sp, and raises where they run out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pm.make_mesh(sp=2).shape == {"dp": 2, "sp": 2}
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pm.process_cards(sp=2) == [torch.device("cuda", 2), torch.device("cuda", 3)]
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="sees 4"):
        pm.process_cards(sp=2)


@pytest.mark.parametrize("n", [2, 3])
def test_dp_split_pads_and_gather_restores(n):
    x = torch.arange(5 * 2, dtype=torch.float32).reshape(5, 2)
    parts = pm.dp_split(x, ["cpu"] * n)
    assert len(parts) == n and len({p.shape[0] for p in parts}) == 1
    assert torch.equal(parts[-1][-1], x[-1])     # the pad repeats the last entry
    assert torch.equal(pm.dp_gather(parts, 5, "cpu"), x)


@pytest.mark.parametrize("sp", [2, 4])
def test_halo_w_chain_and_its_adjoint_match_the_unsplit_chain(sp):
    """A D2DT chain on haloed shards, cropped: the unsplit chain's output,
    and (through the halo's adjoint) its dx and dW."""
    chain = D2DT(5, 6, 8, "plain_xavier", torch.Generator().manual_seed(3))
    x = torch.from_numpy(_rand(4, (1, 3, 6, 20, 5))).requires_grad_(True)
    g = torch.from_numpy(_rand(5, (1, 3, 6, 20, 6), normal=True))
    y = chain(x)
    dx, dw = torch.autograd.grad((y * g).sum(), (x, chain.chain.conv1.weight))
    xs = pm.shard_w(x, ["cpu"] * sp) if sp == 2 else list(x.split([4, 6, 6, 4], dim=3))
    ys = pm.unhalo_w([chain(p) for p in pm.halo_w(xs, HALO)], HALO)
    y_split = pm.gather_w(ys, "cpu")
    dx2, dw2 = torch.autograd.grad((y_split * g).sum(), (x, chain.chain.conv1.weight))
    assert torch.equal(y_split, y)
    # the halo's gradient adds into its columns in another order
    _close(dx2, dx, 1e-6)
    _close(dw2, dw, 1e-6)


@pytest.mark.parametrize("sp", [2, 4])
def test_global_agg_split_matches_the_module(sp):
    """W 20: no multiple of 32 * sp, so adaptive windows straddle shards."""
    agg = GlobalAgg(6, torch.Generator().manual_seed(6))
    x = torch.from_numpy(_rand(7, (2, 3, 9, 20, 6))).requires_grad_(True)
    want = agg(x)
    split = WidthSplitGMM.__new__(WidthSplitGMM)
    split.reps, split.master = pm.Replicas(), torch.device("cpu")
    got = pm.gather_w(split.global_agg(agg, pm.shard_w(x, ["cpu"] * sp) if sp == 2
                                       else list(x.split([5, 4, 6, 5], dim=3))), "cpu")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    g = torch.from_numpy(_rand(8, want.shape, normal=True))
    a = torch.autograd.grad((want * g).sum(), (x, agg.proj1_w, agg.fc_w))
    b = torch.autograd.grad((got * g).sum(), (x, agg.proj1_w, agg.fc_w))
    for u, v in zip(b, a):
        _close(u, v, 1e-6)


@pytest.mark.parametrize("sp", [2, 4])
def test_gaussian_downsample_by_shards(sp):
    x = torch.from_numpy(_rand(9, (1, 2, 32, 64, 3)))
    got = pm.gather_w(gaussian_downsample_shards(pm.shard_w(x, ["cpu"] * sp), 4), "cpu")
    torch.testing.assert_close(got, gaussian_downsample(x, 4), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# mesh_sp: the training step and the roundtrip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,sp,option", [(1, 2, None), (2, 2, "remat"), (1, 2, "mixed_precision")],
                         ids=["1-2", "2-2", "1-2-bf16"])
def test_split_step_matches_the_unsplit_step(stacks, unsplit_step, monkeypatch, dp, sp, option):
    """The step on the mesh's first row alone (a dp 2 mesh trains as its
    first row does), with the width over its sp cards. ``remat`` (each
    coupling block recomputed in the backward) computes the same function
    as the unsplit step without it; ``mixed_precision`` (bf16 activations)
    is held to the unsplit bf16 step, at the bf16 tolerances."""
    _, tree, x, eps = stacks
    network = {"remat": True} if option == "remat" else None
    train = {"mixed_precision": True} if option == "mixed_precision" else None
    rematted = []
    monkeypatch.setattr(spatial, "checkpoint", lambda f, *a, **kw: rematted.append(f) or checkpoint(f, *a, **kw))
    logs, grads, _ = _stepped(tree, x, eps, _cpus(dp, sp), network, train)
    # one a coupling block (2) in the encode and in the decode
    assert len(rematted) == (4 if option == "remat" else 0)
    want_logs, want, _ = _stepped(tree, x, eps, _cpus(1, 1), train=train) if train else unsplit_step
    loss_rel, leaf_rel, attention_rel = (5e-5, 1e-2, 5e-2) if train else (1e-6, 1e-6, 1e-5)
    for k in ("loss", "l_forw_fit", "l_back_rec"):
        assert abs(logs[k] - want_logs[k]) <= loss_rel * abs(want_logs[k]), k
    for k, g in grads.items():
        if k.endswith("proj3_b"):
            continue
        limit = attention_rel if any(a in k for a in ATTENTION) else leaf_rel
        assert (g - want[k]).norm() <= limit * want[k].norm(), k


@pytest.fixture(scope="module")
def jax_step(stacks):
    """The JAX package's unsplit roundtrip and loss (selfc_tpu/train/
    rescale_model.py ``_pixel_losses``) and its gradient, on the fed eps."""
    jm, tree, x, eps = stacks
    ref_l = jresize.gaussian_downsample(jnp.asarray(x), 4)

    def loss_fn(params):
        saved = jgmm.sample_normal
        jgmm.sample_normal = lambda rng, shape, dtype: jnp.asarray(eps)
        try:
            out = jm.apply({"params": params}, jnp.asarray(x), method=jm.roundtrip,
                           rngs={"sample": jax.random.PRNGKey(0)})
        finally:
            jgmm.sample_normal = saved
        l_forw = jlosses.reconstruction_loss(out["lr_pre_quant"], ref_l, "l2")
        l_back = jlosses.reconstruction_loss(out["hr"], jnp.asarray(x), "l1")
        return (l_forw + l_back) * 144 * 144 * 3, out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jax.tree.map(jnp.asarray, tree))
    return float(loss), jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, grads)


def test_split_roundtrip_matches_jax(stacks, jax_step):
    jm, tree, x, eps = stacks
    model = RescaleModel(_opt(2), device="cpu", mesh=_cpus(1, 2))
    model.load_jax_params(tree)
    cpus = ["cpu", "cpu"]
    split = WidthSplitGMM(model.net, pm.Replicas(), "cpu")
    with torch.no_grad():
        out = split.roundtrip(pm.shard_w(torch.from_numpy(x), cpus),
                              pm.shard_w(torch.from_numpy(eps), cpus, axis=3))
    want = jax_step[1]
    np.testing.assert_allclose(pm.gather_w(out["lr_pre_quant"], "cpu").numpy(), want["lr_pre_quant"], atol=1e-4)
    # the same levels (jitted, XLA divides by 255 as a product: the last bit may differ)
    np.testing.assert_allclose(pm.gather_w(out["lr"], "cpu").numpy(), want["lr"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(pm.gather_w(out["hr"], "cpu").numpy(), want["hr"], atol=1e-4)


def test_split_step_matches_jax(stacks, jax_step):
    """Leaf by leaf, the port's clipped ``.grad`` scaled back by norm / clip,
    as ``test_torch_train.py`` holds the unsplit step."""
    _, tree, x, eps = stacks
    logs, _, model = _stepped(tree, x, eps, _cpus(1, 2))
    loss, _, jgrads = jax_step
    np.testing.assert_allclose(logs["loss"], loss, rtol=1e-5)
    want, got = flatten_tree(jgrads), flatten_tree(export_jax_grads(model.net))
    assert set(got) == set(want)
    norm = float(model.grad_norm)
    scale = max(1.0, norm / TRAIN["gradient_clipping"])
    top = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        # proj3_b's gradient is zero by construction: rounding noise on both sides
        ref = top if np.abs(v).max() < 1e-6 * top else np.abs(v).max()
        np.testing.assert_allclose(got[k] * scale, v, rtol=0, atol=1e-3 * ref, err_msg=k)


def test_split_test_matches_the_unsplit_test(stacks):
    """``test()`` with the width of its one-group calls split over sp 2: the
    same eps stream, the LR quantised once on the master (one shared
    tensor), the decode from it."""
    _, tree, _, _ = stacks
    clip = _rand(10, (1, 9, 32, 64, 3))
    out = []
    for mesh in (_cpus(1, 1), _cpus(1, 2)):
        model = RescaleModel(_opt(mesh.sp, is_train=False, gop_batch=1), device="cpu", mesh=mesh, rng_seed=4)
        model.load_jax_params(tree)
        model.feed_data({"GT": clip})
        model.test(gop=7)
        out.append((model.forw_L, model.forw_H, model.fake_H, model.sample_H))
    for a, b in zip(*out):
        assert a.shape == b.shape
    assert np.array_equal(out[0][0], out[1][0]) and np.array_equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[1][2], out[0][2], atol=1e-5)
    np.testing.assert_allclose(out[1][3], out[0][3], atol=1e-5)


# ---------------------------------------------------------------------------
# eval over the dp rows (mirrors tests/test_mesh_eval.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gop_batch", [2, 3])
def test_rescale_test_over_dp_equals_one_device(stacks, gop_batch):
    """18 frames, gop 7: 3 groups. gop_batch 2: two calls of 2 groups (the
    second padded), each split 1 + 1; gop_batch 3: one call of 3, padded to
    4 for the split. The GMM prior draws its eps on the master, in order."""
    _, tree, _, _ = stacks
    clip = _rand(11, (1, 18, 32, 32, 3))
    out = []
    for mesh in (_cpus(1, 1), _cpus(2, 1)):
        model = RescaleModel(_opt(is_train=False, gop_batch=gop_batch), device="cpu", mesh=mesh, rng_seed=5)
        model.load_jax_params(tree)
        model.feed_data({"GT": clip})
        model.test(gop=7)
        out.append((model.fake_H, model.forw_L, model.forw_H, model.sample_H))
    for a, b in zip(*out):
        assert np.array_equal(a, b)


def test_codec_test_over_dp_equals_one_device(monkeypatch):
    """The streaming codec eval's batched encode (seg_batch * 2 width
    halves) and decode (seg_batch * 4 tiles) calls split over dp 2."""
    monkeypatch.setenv("SELFC_TPU_DISABLE_X265", "1")
    monkeypatch.delenv("SELFC_TPU_STANDIN_CODEC", raising=False)
    net = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1], "scale": 2, "init": "xavier",
           "global_module": "nonlocal", "stp_blk_num": 2, "fh_loss": "l2", "h265_q": 16,
           "stp_hidden_c": 8, "stp_denseblock_innerc": 4}
    opt = dict_to_nonedict({"model": "SelfC_GMM_Codec", "scale": 2, "network_G": net,
                            "val": {"batch_tiles": True, "seg_batch": 4, "overlap": True}})
    clip = _rand(12, (1, 7, 32, 32, 3))
    out = []
    for mesh in (_cpus(1, 1), _cpus(2, 1)):
        model = CodecModel(opt, device="cpu", mesh=mesh, rng_seed=3)
        model.feed_data({"GT": clip})
        model.test()
        out.append((model.fake_H, np.asarray(model.forw_L), model.video_bpp))
    assert np.array_equal(out[0][0], out[1][0]) and np.array_equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2]


# ---------------------------------------------------------------------------
# what the width split takes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["IRN"])
def test_create_model_refuses_sp_for_the_other_nets(model):
    """IRN has no wrapper to split: ``RescaleModel`` refuses it at any sp,
    as the JAX package's cannot build it."""
    with pytest.raises(NotImplementedError, match="cannot build it either"):
        create_model(_opt(2, model=model), device="cpu")


CODEC_NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1], "scale": 2, "init": "xavier",
             "global_module": "nonlocal", "stp_blk_num": 1, "fh_loss": "l2", "h265_q": 16,
             "stp_hidden_c": 8, "stp_denseblock_innerc": 4}


@pytest.mark.parametrize("model", ["SelfC_GMM_Codec", "SelfC"])
def test_create_model_takes_sp_for_the_codec_and_haar_nets(model):
    """``mesh_sp: 2`` builds the codec's trainer (with its surrogate) and
    the Haar net's (model type SelfC and its other name SelfC_shell) on a
    row of two devices; each takes the widths its split rule allows
    (``tests/test_torch_mesh_nets.py`` holds the rules)."""
    for name in (["SelfC", "SelfC_shell"] if model == "SelfC" else [model]):
        opt = _opt(2, model=name)
        if model == "SelfC_GMM_Codec":
            opt["scale"], opt["network_G"] = 2, dict_to_nonedict(CODEC_NET)
            opt["train"].update(noise_type="h265", h265_sug=True)
        m = create_model(opt, device="cpu")
        assert m.mesh.shape == {"dp": 1, "sp": 2}
        assert type(m.net).__name__ == ("SelfCNetCodec" if model == "SelfC_GMM_Codec" else "SelfCNetHaar")
        assert m.feed_data({"GT": _rand(0, (1, 3, 16, 80 if model == "SelfC_GMM_Codec" else 32, 3))}) == 3


def test_create_model_takes_sp_for_selfc_gmm_and_checks_the_width():
    model = create_model(_opt(2), device="cpu")
    assert model.mesh.shape == {"dp": 1, "sp": 2}
    for W in (36, 24):   # LR shards of 4.5 and of 3 columns
        with pytest.raises(ValueError, match="whole LR columns"):
            model.feed_data({"GT": _rand(0, (1, 3, 32, W, 3))})
    assert model.feed_data({"GT": _rand(0, (1, 3, 32, 40, 3))}) == 3


@pytest.mark.parametrize("what", ["hg", "pipeline", "gan", "matlab"])
def test_split_refuses_what_crosses_shards_otherwise(what):
    """The options the width split once refused (the H/G pair, the
    pipelined codec step, the adversarial branch, the MATLAB resize's
    target: ROADMAP Queue A items 1a-1d) build at sp 2; what the split
    still refuses is a shard narrower than a block's halo, which the halo
    would cross: ``feed_data`` raises, naming the width rule.
    ``tests/test_torch_mesh_opts.py`` holds each option's split step."""
    opt = _opt(2, network={"chain_variants": ["hg"]} if what == "hg" else None)
    if what == "gan":
        opt["train"]["gan_weight"] = 5e-3
    if what == "matlab":
        opt["distortion"] = "matlab"
    if what == "pipeline":
        opt["model"], opt["scale"], opt["network_G"] = "SelfC_GMM_Codec", 2, dict_to_nonedict(CODEC_NET)
        opt["train"].update(noise_type="h265", codec_pipeline=True)
        model, (bad, good) = CodecModel(opt, device="cpu"), (12, 16)   # LR shards of 3 and 4 columns
    else:
        model, (bad, good) = RescaleModel(opt, device="cpu"), (24, 40)
    assert model.mesh.shape == {"dp": 1, "sp": 2}
    with pytest.raises(ValueError, match="at least 8 wide" if what == "pipeline" else "at least 16 wide"):
        model.feed_data({"GT": _rand(0, (1, 3, 16, bad, 3))})
    assert model.feed_data({"GT": _rand(0, (1, 3, 16, good, 3))}) == 3


def test_every_kernel_launch_runs_on_its_tensors_card():
    """Each library call that launches (``err = lib.selfc_...``) sits inside
    ``with build.on_device(x)``: the libraries launch on the runtime's
    current device, which need not be the tensor's."""
    assert build.on_device(torch.zeros(1)).__class__.__name__ == "nullcontext"
    n = 0
    for module in (dense_chain, temporal_conv, chain_variants, deform):
        tree = ast.parse(inspect.getsource(module))
        guarded = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    ast.unparse(item.context_expr).startswith("build.on_device(") for item in node.items):
                guarded.update(id(n) for n in ast.walk(node))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                    and ast.unparse(node.targets[0]) == "err"
                    and ast.unparse(node.value.func).startswith("lib.selfc_")):
                assert id(node) in guarded, f"{module.__name__}: {ast.unparse(node.value.func)}"
                n += 1
    assert n == 9
