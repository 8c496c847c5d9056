"""The image width split (``mesh_sp``, ``selfc_tpu_torch/parallel/spatial.py``)
of the options it once refused, on meshes of repeated ``"cpu"`` devices: the
adversarial step (D and F on the gathered whole frames), the H/G pair
(``chain_variants: [hg]``, B7's plain version on haloed shards), the other
subnet families (the plain coupling, the halos of ``D2DTEnhance`` and
``HighOrderTNet``), the MATLAB target by shards and the pipelined codec step.

Sizes: SelfC_GMM at 4x, ``block_num [1, 1]`` (the GAN net: ``[1]``, as in
``tests/test_torch_gan.py``, on its 32 x 32 clip), ``stp_blk_num`` 1 or 2;
the subnet families at 2x, ``block_num [1]``, each at the least width
``width_rule`` takes (``HighOrderTNet`` reaches 80 LR columns: 320 HR
columns); the codec net of ``tests/test_torch_codec_train.py`` on
``(2,3,16,16,3)`` with the straight-through swap.

Tolerances:
- a split step against the port's unsplit step: the loss (and the GAN's
  other losses) within 1e-6 relative, every gradient leaf within 1e-6
  relative l2; the attention's leaves of ``GlobalAgg`` (``fc``, ``proj2``,
  ``proj3_w``) within 1e-5, ``proj3_b`` (zero by construction) left out
  (the tolerances of ``tests/test_torch_mesh.py``); an attention leaf
  smaller than 1e-5 of the largest leaf (its gradient a sum that cancels:
  ``fc_b`` in the GAN step, 1.9e-6) held on that scale; in the GAN step
  D's leaves as G's, D's running statistics within 1e-6 relative l2; the
  pipelined steps' parameters after each update within 1e-6 relative l2.
  The subnet families' steps:
  the whole gradient within 1e-6 relative l2 and each leaf within 1e-5 (a
  leaf is a sum over every pixel that the split adds in another order, and
  through these families' library convolutions, which take other
  algorithms at a shard's width, the worst leaf moves 1.1e-6 to 1.4e-6:
  ``HighOrderTNet``'s ``up2.bias``, ``FeatureCollapse``'s ``conv1``);
- a split step against the JAX package's unsplit step: the GAN step as
  ``tests/test_torch_gan.py`` holds the unsplit one (logs 1e-4 relative,
  ``D_real`` / ``D_fake`` 1e-5 absolute, G's and D's parameters and D's
  running statistics after the step 1e-4 relative l2); the ``hg`` net as
  ``tests/test_torch_chain_variants.py`` holds it (the roundtrip's outputs
  1e-4 absolute, with JAX's pair kernel interpreted; the gradient 1e-4
  relative l2 over the tree, JAX's on its XLA path);
- ``block_reach`` against a probe in float64: one input column perturbed,
  the farthest output column that moves is the reach (``HighOrderTNet``:
  its reach rounded up to its 8-column grid);
- ``test()`` with ``hg`` at sp 2 against sp 1: the LR and the latent the
  same bits, the HR and the sample within 1e-5 (``tests/test_torch_mesh.py``);
- the MATLAB target by shards against ``imresize_matlab`` of the whole
  image: the same bits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
from selfc_tpu.ops import gmm as jgmm
from selfc_tpu.ops import resize as jresize
from selfc_tpu.train import losses as jlosses
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models import discriminator as tdisc
from selfc_tpu_torch.models.blocks import D2DTEnhance, HighOrderTNet
from selfc_tpu_torch.ops.resize import matlab_reach, matlab_taps
from selfc_tpu_torch.parallel import mesh as pm
from selfc_tpu_torch.parallel import spatial
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.train.rescale_model import RescaleModel, make_degrade
from selfc_tpu_torch.utils.jax_import import export_jax_grads, export_jax_params, flatten_tree, load_jax_params
from test_torch_codec_train import _train_opt as _codec_opt
from test_torch_gan import _d_tree, _jax_g, _jax_step, _opt_dict, _vgg_tree, tree_rel_l2
from test_torch_mesh_nets import _haar_opt, _tree_for
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


@pytest.fixture(autouse=True, scope="module")
def _drop_cached_cases():
    yield
    _gan_case.cache_clear()
    _hg_case.cache_clear()


ATTENTION = (".fc_", ".proj2_", ".proj3_w")
NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1, 1], "scale": 4, "init": "xavier",
       "global_module": "nonlocal", "stp_blk_num": 2, "fh_loss": "gmm", "gmm_k": 2}
TRAIN = {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "lr_scheme": "MultiStepLR", "lr_steps": [],
         "lr_gamma": 0.5, "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1",
         "lambda_fit_forw": 1, "lambda_rec_back": 1, "lambda_cond_prob": 0, "gradient_clipping": 10}


def _cpus(sp):
    return pm.make_mesh(dp=1, sp=sp, devices=["cpu"] * sp)


def _rand(seed, shape, normal=False):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) if normal else rng.random(shape)).astype(np.float32)


def _opt(sp, network=None, distortion="sr_bd", **train):
    network = dict(NET, **(network or {}))
    return dict_to_nonedict({
        "is_train": True, "model": "SelfC_GMM", "distortion": distortion, "scale": network["scale"],
        "mesh_sp": sp, "datasets": {"train": {"video_len": 3}}, "network_G": network, "path": {},
        "train": dict(TRAIN, **train)})


def _grads(module):
    return {k: p.grad.clone() for k, p in module.named_parameters() if p.grad is not None}


def _assert_close_steps(got, want, keys, leaf_rel=1e-6):
    """A split step ``(logs, grads)`` against the unsplit one; ``leaf_rel``
    > 1e-6 holds the whole gradient to 1e-6 besides."""
    (got_logs, got_grads), (want_logs, want_grads) = got, want
    for k in keys:
        assert abs(got_logs[k] - want_logs[k]) <= 1e-6 * abs(want_logs[k]), (k, got_logs[k], want_logs[k])
    assert set(got_grads) == set(want_grads) and got_grads
    top = max(g.norm().item() for g in want_grads.values())
    held = [k for k in got_grads if not k.endswith("proj3_b")]
    for k in held:
        g, ref = got_grads[k], want_grads[k].norm().item()
        limit = leaf_rel
        if any(a in k for a in ATTENTION):
            limit, ref = max(1e-5, leaf_rel), max(ref, 1e-5 * top)
        assert (g - want_grads[k]).norm() <= limit * ref, (k, (g - want_grads[k]).norm().item(), ref)
    if leaf_rel > 1e-6:
        num = sum(((got_grads[k] - want_grads[k]).double() ** 2).sum() for k in held)
        den = sum((want_grads[k].double() ** 2).sum() for k in held)
        assert (num / den) ** 0.5 <= 1e-6


def _step_pair(opt_fn, tree, x, eps, keys, leaf_rel=1e-6):
    """The port's sp 1 and sp 2 steps from one tree, clip and eps."""
    out = []
    for sp in (2, 1):
        model = RescaleModel(opt_fn(sp), device="cpu", mesh=_cpus(sp))
        model.load_jax_params(tree)
        model.feed_data({"GT": x})
        model.optimize_parameters(0, eps=eps)
        out.append((dict(model.get_current_log()), _grads(model.net)))
    _assert_close_steps(*out, keys, leaf_rel=leaf_rel)


# ---------------------------------------------------------------------------
# the reaches of the other families, and the widths they need
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["D2DTEnhance", "HighOrderTNet"])
def test_block_reach_matches_a_probe(family):
    """Perturb one input column (at each phase of the block's grid) and see
    which output columns move: the farthest is the reach ``block_reach``
    derives from the convs (``HighOrderTNet``'s rounded up to its grid)."""
    g = torch.Generator().manual_seed(0)
    block = D2DTEnhance(4, 4, gc=4, generator=g) if family == "D2DTEnhance" else HighOrderTNet(3, 3, generator=g)
    load_jax_params(block, _tree_for(block, 1))
    block.double()
    reach, grid = spatial.block_reach(block)
    W = 256 if family == "HighOrderTNet" else 24
    x = torch.from_numpy(_rand(2, (1, 2, 8, W, block.conv1.weight.shape[2] if family == "D2DTEnhance" else 3)))
    x = x.double()
    with torch.no_grad():
        y = block(x)
        far = 0
        for phase in range(grid):
            c = W // 2 + phase
            xp = x.clone()
            xp[..., c, :] += 1.0
            moved = ((block(xp) - y).abs().amax(dim=(0, 1, 2, 4)) > 0).nonzero().flatten()
            far = max(far, int((moved - c).abs().max()))
    if family == "D2DTEnhance":
        assert (reach, grid) == (far, 1) == (4, 1)
    else:
        assert grid == 8 and far <= reach < far + grid and reach == 80


@pytest.mark.parametrize("W", [512, 672])
def test_width_rule_refuses_a_narrow_high_order_shard(W):
    """``HighOrderTNet``'s halo is 80 LR columns on an 8-column grid: at 4x
    and sp 2 a shard needs 320 HR columns in multiples of 32. 512 (256 a
    shard) is too narrow, 672 (336) off the grid: both refused with the
    block named; 640 splits."""
    model = RescaleModel(_opt(2, {"which_model_G": {"subnet_type": "HighOrderTNet"}}), device="cpu",
                         mesh=_cpus(2))
    assert spatial.width_rule(model.net)[:2] == (32, 320)
    what = "at least 320 wide .80 LR columns: the halo of inv_blocks_0" if W == 512 else \
        "a multiple of 32 HR columns .set by inv_blocks_0"
    with pytest.raises(ValueError, match=what):
        model.feed_data({"GT": _rand(0, (1, 3, 32, W, 3))})
    assert model.feed_data({"GT": _rand(0, (1, 3, 32, 640, 3))}) == 3


# ---------------------------------------------------------------------------
# the MATLAB target
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale,widths", [(4, (32, 32)), (4, (16, 48, 32, 16)), (2, (8, 8))])
def test_matlab_target_by_shards_is_the_whole_target(scale, widths):
    """Each shard's LR columns are the rows of the whole image's taps read
    from its haloed shard (the halo from the taps' support: 6 HR columns
    at 4x, 3 at 2x): ``imresize_matlab`` of the whole image, the same bits,
    the reflection at the true edges only."""
    x = torch.from_numpy(_rand(3, (2, 3, 16, sum(widths), 3)))
    whole = make_degrade("matlab", scale)(x)
    got = spatial.degrade_shards("matlab", list(x.split(widths, dim=3)), scale, None)
    assert torch.equal(torch.cat(got, dim=3), whole)
    W = sum(widths)
    assert matlab_reach(matlab_taps(W, W // scale, 1.0 / scale)[0], scale) == {4: 6, 2: 3}[scale]


@pytest.mark.parametrize("net", ["haar", "codec"])
def test_matlab_split_step_matches_the_unsplit_step(net):
    """``distortion: matlab`` with the width over sp 2: the Haar SelfC net's
    step (4x) and the codec's (2x, the straight-through swap)."""
    if net == "haar":
        tree = _tree_for(RescaleModel(_haar_opt(1), device="cpu").net, 40)
        x = _rand(41, (1, 3, 16, 32, 3))
        eps = _rand(42, RescaleModel(_haar_opt(1), device="cpu").net.eps_shape((1, 3, 4, 8, 3)), normal=True)

        def opt_fn(sp):
            opt = _haar_opt(sp)
            opt["distortion"] = "matlab"
            return opt
        _step_pair(opt_fn, tree, x, eps, ("loss", "l_forw_fit", "l_back_rec", "loss_c"))
        return
    x, codec_out = _rand(43, (2, 3, 16, 16, 3)), _rand(44, (2, 3, 8, 8, 3))
    out, tree = [], None
    for sp in (2, 1):
        opt = _codec_opt(h265_sug=False)
        opt["distortion"] = "matlab"
        model = CodecModel(opt, device="cpu", mesh=_cpus(sp))
        tree = tree or _tree_for(model.params, 45)
        model.load_jax_params(tree)
        model.feed_data({"GT": x})
        model.optimize_parameters(0, codec_out=codec_out)
        out.append((dict(model.get_current_log()), _grads(model.params)))
    _assert_close_steps(*out, ("loss", "l_forw_fit", "l_back_rec", "distortion_loss"))


# ---------------------------------------------------------------------------
# the adversarial step
# ---------------------------------------------------------------------------

GAN_X, GAN_EPS = (1, 3, 32, 32, 3), (1, 3, 8, 8, 48, 2)
GAN_CASES = {"ragan": 1.0, "gan": 0.0, "lsgan": 1.0, "wgan-gp": 0.0}   # gan_type: feature_weight


@functools.lru_cache(maxsize=None)
def _gan_case(gan_type):
    """``tests/test_torch_gan.py``'s step inputs (the same seeds, so that its
    JAX step is the same program) and the port's sp 2 and sp 1 steps: each
    ``(logs, G's and D's gradients as 'G.*' / 'D.*', the models)``."""
    fea_w = GAN_CASES[gan_type]
    x = np.random.default_rng(12).random(GAN_X, dtype=np.float32)
    g_tree = seeded_tree(_jax_g(), 13, jnp.asarray(x), method=JSelfCNetGMM.roundtrip)
    _, d_params, d_stats = _d_tree(8, 32, 14)
    f_tree = _vgg_tree(4, 15, 32)[1] if fea_w else {}
    e = np.random.default_rng(16).normal(0, 1, GAN_EPS).astype(np.float32)
    gp_eps = np.random.default_rng(17).random((3, 1, 1, 1), dtype=np.float32)
    steps = {}
    for sp in (2, 1):
        opt = _opt_dict(gan_type=gan_type, feature_weight=fea_w)
        opt["mesh_sp"] = sp
        model = RescaleModel(dict_to_nonedict(opt), device="cpu", mesh=_cpus(sp))
        model.load_jax_params(g_tree)
        load_jax_params(model.gan.netD, d_params)
        model.gan.load_stats(d_stats)
        if fea_w:
            model.gan.netF = tdisc.VGGFeatureExtractor(feature_layer=4, device="cpu").requires_grad_(False)
            load_jax_params(model.gan.netF, f_tree)
        model.feed_data({"GT": x})
        model.optimize_parameters(1, eps=e, gp_eps=gp_eps if gan_type == "wgan-gp" else None)
        grads = {**{f"G.{k}": g for k, g in _grads(model.net).items()},
                 **{f"D.{k}": g for k, g in _grads(model.gan.netD).items()}}
        steps[sp] = (dict(model.get_current_log()), grads, model)
    return (g_tree, d_params, d_stats, f_tree, x, e), steps


@pytest.mark.parametrize("gan_type", sorted(GAN_CASES))
def test_gan_split_step_matches_the_unsplit_step(gan_type):
    """The combined G + D step with the width over sp 2 ('ragan' and
    'lsgan' with the feature loss, 'gan' and 'wgan-gp' with a fed
    ``gp_eps`` without): G's pixel losses by shards, the fake gathered
    whole for F and D; D's step on the master. Its losses, G's and D's
    gradients and D's running statistics against the sp 1 step."""
    _, steps = _gan_case(gan_type)
    keys = ["loss", "l_forw_fit", "l_back_rec", "l_g_gan", "l_d"] + (["l_g_fea"] if GAN_CASES[gan_type] else [])
    _assert_close_steps(steps[2][:2], steps[1][:2], keys)
    assert tree_rel_l2(steps[2][2].gan.stats_numpy(), steps[1][2].gan.stats_numpy()) <= 1e-6


@pytest.mark.parametrize("gan_type", ["ragan", "wgan-gp"])
def test_gan_split_step_matches_jax(gan_type):
    """The sp 2 step against the JAX package's ``AdversarialBranch.train_step``
    (``tests/test_torch_gan.py``'s program, with its interpolation weights
    fed for 'wgan-gp'): logs, G's and D's parameters and D's statistics."""
    (g_tree, d_params, d_stats, f_tree, x, e), _ = _gan_case(gan_type)
    want, gp_eps, _, _ = _jax_step(gan_type, GAN_CASES[gan_type], g_tree, d_params, d_stats, f_tree, x, e)
    opt = _opt_dict(gan_type=gan_type, feature_weight=GAN_CASES[gan_type])
    opt["mesh_sp"] = 2
    model = RescaleModel(dict_to_nonedict(opt), device="cpu", mesh=_cpus(2))
    model.load_jax_params(g_tree)
    load_jax_params(model.gan.netD, d_params)
    model.gan.load_stats(d_stats)
    if GAN_CASES[gan_type]:
        model.gan.netF = tdisc.VGGFeatureExtractor(feature_layer=4, device="cpu").requires_grad_(False)
        load_jax_params(model.gan.netF, f_tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(1, eps=e, gp_eps=gp_eps if gan_type == "wgan-gp" else None)
    logs = model.get_current_log()
    for k, v in want[5].items():
        tol = 1e-5 if k in ("D_real", "D_fake") else 1e-4 * max(abs(float(v)), 1e-6)
        assert abs(logs[k] - float(v)) <= tol, (k, logs[k], v)
    assert tree_rel_l2(export_jax_params(model.net), want[0]) <= 1e-4
    assert tree_rel_l2(export_jax_params(model.gan.netD), want[2]) <= 1e-4
    assert tree_rel_l2(model.gan.stats_numpy(), want[3]) <= 1e-4


# ---------------------------------------------------------------------------
# the H/G pair
# ---------------------------------------------------------------------------

HG_CLIP, HG_EPS = (1, 3, 16, 64, 3), (1, 3, 4, 16, 48, 2)
HG = {"chain_variants": ["hg"], "stp_blk_num": 1}


@functools.lru_cache(maxsize=None)
def _hg_case():
    """The JAX net's seeded tree, clip and eps; the port's sp 2 step."""
    x = _rand(50, HG_CLIP)
    jm = JSelfCNetGMM(scale=4, block_num=(1, 1), stp_blk_num=1, gmm_k=2)
    tree = seeded_tree(jm, 51, jnp.asarray(x), method=jm.roundtrip)
    eps = _rand(52, HG_EPS, normal=True)
    model = RescaleModel(_opt(2, HG), device="cpu", mesh=_cpus(2))
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, eps=eps)
    return jm, tree, x, eps, (dict(model.get_current_log()), _grads(model.net)), model


def test_hg_split_step_matches_the_unsplit_step():
    """``chain_variants: [hg]``: H and G as one pair on their shared haloed
    input, x2 zero-padded in the halo, y2 and exp(s) cropped; the sp 2 step
    against the unsplit step (which runs the pair whole)."""
    _, tree, x, eps, split, _ = _hg_case()
    model = RescaleModel(_opt(1, HG), device="cpu", mesh=_cpus(1))
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, eps=eps)
    _assert_close_steps(split, (dict(model.get_current_log()), _grads(model.net)), ("loss", "l_forw_fit", "l_back_rec"))


def test_hg_split_step_matches_jax(monkeypatch):
    """The sp 2 roundtrip against the JAX net with its pair kernel
    (``SELFC_TPU_PALLAS_HG``, interpreted), and the sp 2 step's gradient
    against JAX's on its XLA path."""
    jm, tree, x, eps, _, model = _hg_case()
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

    params = jax.tree.map(jnp.asarray, tree)
    with monkeypatch.context() as m:
        for flag in ("SELFC_TPU_PALLAS", "SELFC_TPU_PALLAS_HG"):
            m.setenv(flag, "1")
        loss, out = jax.jit(loss_fn)(params)   # traced here: the pair kernel, interpreted
    grads = jax.jit(jax.grad(lambda p: loss_fn(p)[0]))(params)
    cpus = ["cpu", "cpu"]
    fresh = RescaleModel(_opt(2, HG), device="cpu", mesh=_cpus(2))   # ``model`` has taken its step
    fresh.load_jax_params(tree)
    split = spatial.splitter(fresh.net, pm.Replicas(), "cpu")
    with torch.no_grad():
        got = split.roundtrip(pm.shard_w(torch.from_numpy(x), cpus), pm.shard_w(torch.from_numpy(eps), cpus, axis=3))
    for k in ("lr_pre_quant", "hr"):
        np.testing.assert_allclose(pm.gather_w(got[k], "cpu").numpy(), np.asarray(out[k]), atol=1e-4, err_msg=k)
    want = {k: np.asarray(v) for k, v in flatten_tree(grads).items()}
    mine = flatten_tree(export_jax_grads(model.net))
    scale = max(1.0, float(model.grad_norm) / TRAIN["gradient_clipping"])
    num = sum(((mine[k] * scale - v).astype(np.float64) ** 2).sum() for k, v in want.items())
    den = sum((v.astype(np.float64) ** 2).sum() for v in want.values())
    assert (num / den) ** 0.5 <= 1e-4
    np.testing.assert_allclose(model.get_current_log()["loss"], float(loss), rtol=1e-5)


def test_hg_split_test_matches_the_unsplit_test():
    """``test()`` with ``hg`` and the width of its one-group calls over sp 2."""
    tree = _hg_case()[1]
    clip = _rand(53, (1, 7, 16, 64, 3))
    out = []
    for sp in (1, 2):
        opt = _opt(sp, HG)
        opt["is_train"], opt["val"] = False, {"gop_batch": 1}
        model = RescaleModel(opt, device="cpu", mesh=_cpus(sp), rng_seed=4)
        model.load_jax_params(tree)
        model.feed_data({"GT": clip})
        model.test(gop=7)
        out.append((model.forw_L, model.forw_H, model.fake_H, model.sample_H))
    assert np.array_equal(out[0][0], out[1][0]) and np.array_equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[1][2], out[0][2], atol=1e-5)
    np.testing.assert_allclose(out[1][3], out[0][3], atol=1e-5)


# ---------------------------------------------------------------------------
# the other subnet families: the plain coupling on shards
# ---------------------------------------------------------------------------

FAMILIES = [("DBNet", "D2DNet"), ("DB3DNet", "DB3DNet_P"), ("D2DLTInput", "D2DTEnhanceInput"),
            ("FeatureCalapseBlock", "FeatureCalapseBlock_SmallC", "FeatureCalapseBlock_Fast"), ("HighOrderTNet",)]


@pytest.mark.parametrize("families", FAMILIES, ids=["+".join(f) for f in FAMILIES])
def test_family_split_step_matches_the_unsplit_step(families):
    """SelfC_GMM at 2x with each family of the ``subnet()`` table as its
    coupling subnets (the plain coupling: F haloed, H and G on one shared
    halo, s and the combine on each shard, the log-jacobian a sum over
    shards): the sp 2 step against the unsplit step, at the least width
    ``width_rule`` takes. Each leaf within 1e-5 and the whole gradient within
    1e-6 relative l2 (the docstring)."""
    for i, family in enumerate(families):
        network = {"which_model_G": {"subnet_type": family}, "scale": 2, "block_num": [1], "stp_blk_num": 1}
        net = RescaleModel(_opt(1, network), device="cpu").net
        multiple, least = spatial.width_rule(net)[:2]
        W, H = 2 * -(-least // multiple) * multiple, 16   # HighOrderTNet: 320; the collapse blocks 80 or 64
        eps = _rand(61 + i, net.eps_shape((1, 3, H // 2, W // 2, 3)), normal=True)
        _step_pair(lambda sp, n=network: _opt(sp, n), _tree_for(net, 60 + i), _rand(62 + i, (1, 3, H, W, 3)), eps,
                   ("loss", "l_forw_fit", "l_back_rec"), leaf_rel=1e-5)


# ---------------------------------------------------------------------------
# the pipelined codec step
# ---------------------------------------------------------------------------


def _sync(dst, src):
    """``dst``'s parameters and Adam state set to ``src``'s bits."""
    with torch.no_grad():
        for p, q in zip(dst.params.parameters(), src.params.parameters()):
            p.copy_(q)
            if q in src.optimizer.state:
                dst.optimizer.state[p] = {k: v.clone() for k, v in src.optimizer.state[q].items()}


@pytest.mark.parametrize("split", ["residual", "reencode"])
def test_pipelined_split_steps_match_the_unsplit_steps(split):
    """Three pipelined calls and ``flush_pipeline`` with the width over sp
    2 (the encode on shards through the parameter copies under 'residual',
    at the live parameters under 'reencode'; each batch's shards kept until
    its retire), beside the same calls unsplit: each retired update's logs,
    gradients and parameters. Before each call the unsplit model takes the
    split one's parameters and moments, so that each update is held from
    one state (a rounding difference carried into the next encode could
    move an LR level)."""
    clips = [_rand(70 + i, (2, 3, 16, 16, 3)) for i in range(3)]
    outs = [_rand(75 + i, (2, 3, 8, 8, 3)) for i in range(3)]
    models = {}
    for sp in (2, 1):
        models[sp] = CodecModel(_codec_opt(h265_sug=False, codec_pipeline=True, codec_split=split), device="cpu",
                                mesh=_cpus(sp))
        models[sp].load_jax_params(_tree_for(models[2].params, 76))
    for i in range(4):
        _sync(models[1], models[2])
        seen = {}
        for sp, model in models.items():
            if i < 3:
                model.feed_data({"GT": clips[i]})
                model.optimize_parameters(i, codec_out=outs[i])
            else:
                model.flush_pipeline()
            log = dict(model.get_current_log())
            assert bool(log) == (i > 0)   # logs lag one call
            seen[sp] = (log, _grads(model.params), {k: p.detach().clone() for k, p in model.params.named_parameters()})
        if i:
            _assert_close_steps(seen[2][:2], seen[1][:2], ("loss", "l_forw_fit", "l_back_rec"))
            for k, p in seen[1][2].items():
                assert (seen[2][2][k] - p).norm() <= 1e-6 * p.norm(), k
