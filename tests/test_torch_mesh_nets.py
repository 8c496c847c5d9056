"""The image width split (``mesh_sp``, ``selfc_tpu_torch/parallel/spatial.py``)
of the nets beyond SelfC_GMM, on meshes of repeated ``"cpu"`` devices: each
block kind on haloed shards, the gathered deformable modules, the codec's
training step (``SelfC_GMM_Codec`` with its surrogate, with and without the
de-artifact net, through the host codec) and the Haar SelfC net's step and
``test()``; the widths each split takes.

Sizes: the codec net of ``tests/test_torch_codec_train.py`` (``block_num
[1]``, ``stp_blk_num 1``, the published surrogate) on ``(2,3,16,80,3)``: the
surrogate's FeatureCollapse blocks reach 20 LR columns, so an sp 2 shard
needs 40 HR columns at least. The Haar net at 4x, ``block_num [1, 1]``,
``stp_temporal_c 8``, on 32 columns (160 with the FeatureCollapse prior),
and at 2x, ``block_num [1]``, on 16 for the JAX comparison.

Tolerances:
- a block on haloed shards against the unsplit block: the forward the same
  bits (each output pixel is computed as the unsplit block computes it),
  the adjoint (dx, dW) within 1e-6 of max |ref| (the halo's gradient adds
  into its columns in another order);
- a gathered deformable module: the forward the same bits, the adjoint
  within 1e-6 of max |ref|;
- a split step against the port's unsplit step: the loss within 1e-6
  relative, every gradient leaf within 1e-6 relative l2, the attention's
  leaves of ``GlobalAgg`` (``fc``, ``proj2``, ``proj3_w``) within 1e-5 (the
  pool is summed by shards); ``proj3_b``'s gradient is zero by construction
  (the softmax over the keys cancels a bias added to every key) and holds
  rounding noise: left out (the tolerances of ``tests/test_torch_mesh.py``);
- a split step, and the codec's unsplit step, against the JAX package's
  unsplit step: as ``tests/test_torch_codec_train.py`` and
  ``tests/test_torch_haar.py`` hold the unsplit one: logs 1e-5 relative,
  each gradient leaf 1e-4 relative l2 (the Haar step: its whole gradient
  1e-4 relative l2); the codec step's clip norm 1e-6 relative (the
  unsplit step's worst leaf at this width, the prior's second
  ``GlobalAgg``'s ``fc_w``, sits 9.3e-6 from JAX's; before the clip's norm
  was summed in float64 on the CPU it sat 1.08e-4, every leaf scaled by
  the norm's ~1e-4 error, 8.6e-5 in ``tests/codec_step_precision.py``);
- the surrogates' loss terms on shards: within 1e-6 relative, the swapped
  values the same bits, the gradient within 1e-6 of max |ref|;
- the host codec's input and output and the bpp: the same bits, split and
  unsplit; ``codec_split: reencode`` at sp 2: the same bits as the residual
  split step;
- the Haar ``test()`` at sp 2 against sp 1: the quantised LR the same
  bits, the latent, the HR and the sample within 1e-5 (the CPU's
  convolutions may pick another algorithm at a shard's width: the last bit
  of a level-2 latent moves).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.config import dict_to_nonedict as jnonedict
from selfc_tpu.models.inv_nets import SelfCNetHaar as JSelfCNetHaar
from selfc_tpu.ops import resize as jresize
from selfc_tpu.train.rescale_model import RescaleModel as JRescaleModel
from selfc_tpu_torch.codec.surrogate import mimick_and_swap, mimick_plain
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models.agg import GroupedGlobalDeformAgg
from selfc_tpu_torch.models.blocks import D2DT, DenseBlock2D, FeatureCollapse
from selfc_tpu_torch.models.stp import STPNetSmall
from selfc_tpu_torch.parallel import mesh as pm
from selfc_tpu_torch.parallel import spatial
from selfc_tpu_torch.parallel.spatial import mimick_and_swap_shards, mimick_plain_shards
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.train.rescale_model import RescaleModel
from selfc_tpu_torch.utils.jax_import import export_jax_grads, flatten_tree, load_jax_params, nest_tree
from test_torch_codec_train import TRAIN as CODEC_TRAIN
from test_torch_codec_train import _jax_codec, _train_opt
from test_torch_haar import _fed
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
    """The cases' models (the surrogate's 26 M parameters with Adam's
    moments) are freed when this file's tests end, not with the worker."""
    yield
    _codec_case.cache_clear()
    _haar_case.cache_clear()


ATTENTION = (".fc_", ".proj2_", ".proj3_w")
CODEC_CLIP = (2, 3, 16, 80, 3)
HAAR_NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1, 1], "scale": 4, "init": "xavier",
            "stp_temporal_c": 8, "fh_loss": "gmm", "gmm_mixture_num": 2}
HAAR_TRAIN = {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "lr_scheme": "MultiStepLR", "lr_steps": [],
              "lr_gamma": 0.5, "weight_decay_G": 0.0, "pixel_criterion_forw": "l2",
              "pixel_criterion_back": "l1", "lambda_fit_forw": 1, "lambda_rec_back": 1, "lambda_cond_prob": 0.01}
GMM_NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1, 1], "scale": 4, "init": "xavier",
           "global_module": "deform", "stp_blk_num": 2, "fh_loss": "gmm", "gmm_k": 2}


def _cpus(sp):
    return pm.make_mesh(dp=1, sp=sp, devices=["cpu"] * sp)


def _rand(seed, shape, normal=False):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) if normal else rng.random(shape)).astype(np.float32)


def _close(got, want, rel):
    """``got`` within ``rel`` of max |want| everywhere."""
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), (err, want.abs().max().item())


def _tree_for(module, seed, scale=1.0):
    """Seeded parameters for ``module`` in the JAX package's tree: fan-in
    scaled normal weights (times ``scale``), N(0, 0.05) biases; every leaf
    non-zero, the zero-init ones too."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, p in module.named_parameters():
        std = 0.05 if p.dim() == 1 else scale * float(np.prod(p.shape[:-1])) ** -0.5
        flat[k] = rng.normal(0, std, tuple(p.shape)).astype(np.float32)
    return nest_tree(flat)


def _assert_steps_match(got, want, loss_keys=("loss", "l_forw_fit", "l_back_rec")):
    """A split step against the port's unsplit one (the tolerances of
    ``tests/test_torch_mesh.py``)."""
    (got_logs, got_grads), (want_logs, want_grads) = got, want
    for k in loss_keys:
        assert abs(got_logs[k] - want_logs[k]) <= 1e-6 * abs(want_logs[k]), (k, got_logs[k], want_logs[k])
    assert set(got_grads) == set(want_grads)
    for k, g in got_grads.items():
        if k.endswith("proj3_b"):
            continue
        limit = 1e-5 if any(a in k for a in ATTENTION) else 1e-6
        assert (g - want_grads[k]).norm() <= limit * want_grads[k].norm(), (k, (g - want_grads[k]).norm().item())


# ---------------------------------------------------------------------------
# blocks on haloed shards
# ---------------------------------------------------------------------------


def test_block_reach_is_derived_from_the_conv_kinds():
    """D2DT 4 at any growth (the codec prior's 12, STPNetSmall's blocks),
    DenseBlock2D 5, FeatureCollapse at scale 4 five cells of 4 on the
    4-column grid; the width rules they give each net."""
    g = torch.Generator().manual_seed(0)
    assert spatial.block_reach(D2DT(3, 6, 12, generator=g)) == (4, 1) == (spatial.HALO, 1)
    assert all(spatial.block_reach(b) == (4, 1) for b in STPNetSmall(8, generator=g).blocks())
    assert spatial.block_reach(DenseBlock2D(4, 6, generator=g)) == (5, 1)
    assert spatial.block_reach(FeatureCollapse(2, 2, 4, gc=2, generator=g)) == (20, 4)
    assert [b for b in STPNetSmall(8, condition_func="FC", generator=g).blocks()
            if spatial.block_reach(b) != (20, 4)] == []


def _block(kind):
    g = torch.Generator().manual_seed(3)
    if kind == "DenseBlock2D":
        return DenseBlock2D(4, 6, gc=8, init_mode="plain_xavier", is_res=False, generator=g), 4
    if kind == "FeatureCollapse":
        return FeatureCollapse(2, 2, 4, gc=2, init_mode="plain_xavier", is_res=True, generator=g), 2
    return D2DT(5, 6, 12, "plain_xavier", g), 5


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kind", ["DenseBlock2D", "FeatureCollapse", "D2DT_gc12"])
def test_haloed_block_matches_the_unsplit_block(kind, sp):
    """Each kind on sp shards (at sp 4 of unequal widths, on its grid),
    haloed by its reach and cropped: the unsplit block's output, and
    through the halo's adjoint its dx and dW."""
    block, C = _block(kind)
    reach, grid = spatial.block_reach(block)
    widths = [reach + grid * i for i in ((0, 1) if sp == 2 else (0, 2, 1, 0))]
    x = torch.from_numpy(_rand(4, (1, 3, 8, sum(widths), C))).requires_grad_(True)
    y = block(x)
    g = torch.from_numpy(_rand(5, y.shape, normal=True))
    w = next(block.parameters())
    dx, dw = torch.autograd.grad((y * g).sum(), (x, w))
    split = spatial.WidthSplitGMM.__new__(spatial.WidthSplitGMM)
    split.reps, split.master = pm.Replicas(), torch.device("cpu")
    y_split = pm.gather_w(split.block(block, list(x.split(widths, dim=3))), "cpu")
    dx2, dw2 = torch.autograd.grad((y_split * g).sum(), (x, w))
    assert torch.equal(y_split, y)
    _close(dx2, dx, 1e-6)
    _close(dw2, dw, 1e-6)


def test_gathered_deform_agg_matches_the_module():
    """``GroupedGlobalDeformAgg`` on sp 2 shards, gathered on the master,
    run whole and sharded back: the module's output and its adjoint (the
    gather's adjoint is the split), offsets reaching across the shards."""
    agg = GroupedGlobalDeformAgg(8, 3)
    load_jax_params(agg, _tree_for(agg, 6, scale=3.0))
    x = torch.from_numpy(_rand(7, (1, 3, 6, 16, 8))).requires_grad_(True)
    with torch.no_grad():
        off = agg.deform_inputs(x)[1]
    assert off.abs().max() > 8        # some taps sample the other shard
    want = agg(x)
    split = spatial.WidthSplitGMM.__new__(spatial.WidthSplitGMM)
    split.reps, split.master = pm.Replicas(), torch.device("cpu")
    got = pm.gather_w(split.aggregate(agg, pm.shard_w(x, ["cpu", "cpu"])), "cpu")
    assert torch.equal(got, want)
    g = torch.from_numpy(_rand(8, want.shape, normal=True))
    for u, v in zip(torch.autograd.grad((got * g).sum(), (x, agg.offset_w, agg.realloc1_w)),
                    torch.autograd.grad((want * g).sum(), (x, agg.offset_w, agg.realloc1_w))):
        _close(u, v, 1e-6)


def _gmm_step(sp, tree, x, eps):
    opt = dict_to_nonedict({"is_train": True, "model": "SelfC_GMM", "distortion": "sr_bd", "scale": 4,
                            "mesh_sp": sp, "datasets": {"train": {"video_len": 3}}, "network_G": GMM_NET,
                            "path": {}, "train": HAAR_TRAIN})
    model = RescaleModel(opt, device="cpu", mesh=_cpus(sp))
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, eps=eps)
    return dict(model.get_current_log()), {k: p.grad.clone() for k, p in model.net.named_parameters()}


def test_gmm_with_deform_global_modules_splits():
    """SelfC_GMM with ``global_module: deform`` (the prior's
    ``DeformConvAgg``s gathered): the sp 2 step is the unsplit one's."""
    probe = RescaleModel(dict_to_nonedict({"model": "SelfC_GMM", "scale": 4, "network_G": GMM_NET}), device="cpu")
    tree = _tree_for(probe.net, 9)
    x, eps = _rand(10, (1, 3, 16, 64, 3)), _rand(11, (1, 3, 4, 16, 48, 2), normal=True)
    _assert_steps_match(_gmm_step(2, tree, x, eps), _gmm_step(1, tree, x, eps))


# ---------------------------------------------------------------------------
# the codec's training step
# ---------------------------------------------------------------------------


def _codec_step(opt, tree, x, codec_out, sp):
    model = CodecModel(opt, device="cpu", mesh=_cpus(sp))
    model.load_jax_params(tree)
    assert model.feed_data({"GT": x}) == 3
    model.optimize_parameters(0, codec_out=codec_out)
    return model


def _port(model):
    return ({k: v for k, v in model.get_current_log().items()},
            {k: p.grad.clone() for k, p in model.params.named_parameters()})


@functools.lru_cache(maxsize=None)
def _codec_case(deart: bool):
    """One seeded tree, clip and codec output; the port's sp 1 and sp 2
    steps (clipped gradients, as the model keeps them) and the JAX
    package's unsplit loss and gradient (``_loss`` of ``_encode_lf``, as
    ``tests/test_torch_codec_train.py`` composes them, under one
    ``jax.jit(jax.value_and_grad)``). The plain case runs the surrogate
    (whose reach sets the width: ``CODEC_CLIP``); the de-artifact case the
    straight-through swap (``h265_sug: false``) on 16 columns: its own
    split, the gathered deformable aggregation, needs no more."""
    network = {"deart_net": True} if deart else None
    shape = (2, 3, 16, 16, 3) if deart else CODEC_CLIP
    x = _rand(20, shape)
    codec_out = _rand(21, (*shape[:2], shape[2] // 2, shape[3] // 2, 3))
    jm = _jax_codec(network)
    hr = jnp.asarray(x)
    tree = {"net": seeded_tree(jm.net, 22, hr, method=jm.net.roundtrip)}
    if deart:
        jm.use_surrogate = False
    else:
        tree["surrogate"] = seeded_tree(jm.surrogate, 23, jnp.zeros((1, *codec_out.shape[1:])), jnp.float32(16))
    ref_l = jm.degrade(hr)
    (_, logs), grads = jax.jit(jax.value_and_grad(
        lambda q: jm._loss(q, jm._encode_lf(q, hr), hr, ref_l, jnp.asarray(codec_out),
                           jax.random.PRNGKey(0), jnp.float32(16)), has_aux=True))(tree)
    jax_step = {"logs": {k: float(v) for k, v in logs.items()}, "grads": jax.tree.map(np.asarray, grads)}
    opt = _train_opt(network, h265_sug=not deart)
    steps = {sp: _codec_step(opt, tree, x, codec_out, sp) for sp in (1, 2)}
    return tree, x, codec_out, jax_step, {sp: _port(m) for sp, m in steps.items()}, steps


@pytest.mark.parametrize("deart", [False, True], ids=["plain", "deart"])
def test_codec_split_step_matches_the_unsplit_step(deart):
    """The sp 2 step (the surrogate's blocks haloed; with ``deart_net`` the
    deformable aggregation gathered) against the port's unsplit step, from
    one fed codec output."""
    steps = _codec_case(deart)[4]
    keys = ("loss", "l_forw_fit", "l_back_rec", "distortion_loss") + (() if deart else ("mimick_loss",))
    _assert_steps_match(steps[2], steps[1], keys)


@pytest.mark.parametrize("deart", [False, True], ids=["plain", "deart"])
def test_codec_split_step_matches_jax(deart):
    """The sp 2 step against the JAX package's unsplit step: its logs, and
    leaf by leaf its gradient (the port's clipped leaves scaled back by
    norm / clip) within 1e-4 relative l2; a leaf zero by construction on
    the scale of the largest."""
    _, _, _, jax_step, _, models = _codec_case(deart)
    _assert_codec_step_matches_jax(models[2], jax_step, deart)


def test_codec_unsplit_step_matches_jax():
    """The port's unsplit step at this width against the JAX package's, as
    the split step is held: its clip norm within 1e-6 of JAX's (summed in
    float64), the attention leaves of the prior's second ``GlobalAgg``
    inside 1e-4 (9.3e-6 measured). The de-artifact step's unsplit leaves
    are held in ``tests/test_torch_codec_train.py``."""
    _, _, _, jax_step, _, models = _codec_case(False)
    _assert_codec_step_matches_jax(models[1], jax_step, False)


def _assert_codec_step_matches_jax(model, jax_step, deart):
    logs = model.get_current_log()
    for k, want in jax_step["logs"].items():
        np.testing.assert_allclose(logs[k], want, rtol=1e-5, atol=1e-12, err_msg=k)
    want = flatten_tree(jax_step["grads"])
    got = flatten_tree(export_jax_grads(model.params))
    assert set(got) == set(want) and (deart or any(k.startswith("surrogate.") for k in want))
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in want.values()))
    np.testing.assert_allclose(float(model.grad_norm), norm, rtol=1e-6)
    clip = CODEC_TRAIN["gradient_clipping"]
    assert norm > clip   # the clip is active in this test
    top = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        g = got[k] * (norm / clip)
        if np.abs(v).max() < 1e-6 * top:
            assert np.abs(g - v).max() <= 1e-6 * top, k
            continue
        assert np.linalg.norm(g - v) <= 1e-4 * np.linalg.norm(v), (k, np.linalg.norm(g - v) / np.linalg.norm(v))


def test_codec_split_host_codec_sees_whole_frames(monkeypatch):
    """Without a fed codec output the split step gathers the quantised LR
    to whole frames on the host: the host codec (the zlib stand-in) gets the
    unsplit ``lr_q`` bit for bit and gives the same output and bpp."""
    monkeypatch.setenv("SELFC_TPU_DISABLE_X265", "1")
    monkeypatch.delenv("SELFC_TPU_STANDIN_CODEC", raising=False)
    tree, x = _codec_case(False)[:2]
    seen = {}
    for sp in (1, 2):
        model = CodecModel(_train_opt(), device="cpu", mesh=_cpus(sp))
        model.load_jax_params(tree)
        model.feed_data({"GT": x})
        host = model._host_codec

        def recorded(lr_q, q, sp=sp, host=host):
            out = host(lr_q, q)
            seen[sp] = (lr_q.copy(), out[0].numpy().copy(), out[1])
            return out

        model._host_codec = recorded
        model.optimize_parameters(0)
        log = model.get_current_log()
        assert log["rate_source"] == "zlib" and log["img_bpp"] == seen[sp][2] > 0
    assert seen[1][0].shape == (2, 3, 8, 40, 3)
    for a, b in zip(seen[1], seen[2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", ["reencode", "uniform_noise"])
def test_codec_split_step_variants(variant):
    """``codec_split: reencode`` at sp 2: the same bits as the residual
    split step; the uniform-noise ablation (the noise drawn whole on the
    master from the model's generator: the unsplit stream), sp 2 against
    sp 1."""
    tree, x, codec_out, _, steps, _ = _codec_case(False)
    if variant == "reencode":
        got = _port(_codec_step(_train_opt(codec_split="reencode"), tree, x, codec_out, 2))
        assert got[0] == steps[2][0]
        assert all(torch.equal(g, steps[2][1][k]) for k, g in got[1].items())
        return
    opt, tree = _train_opt(noise_type="uniform", noise_magnitude=1e-2, h265_sug=False), {"net": tree["net"]}
    split, unsplit = (_port(_codec_step(opt, tree, x, codec_out, sp)) for sp in (2, 1))
    _assert_steps_match(split, unsplit)


@pytest.mark.parametrize("sp", [2, 4])
def test_mimick_terms_by_shards(sp):
    """Both surrogates' losses on shards (``mimick_and_swap_shards``, the
    plain variant's ``mimick_plain_shards``): the whole tensor's terms
    within 1e-6 relative, the swapped values the same bits, the
    gradients within 1e-6 of max |ref|."""
    sug = torch.from_numpy(_rand(40, (2, 3, 4, 24, 3))).requires_grad_(True)
    codec = torch.from_numpy(_rand(41, sug.shape))
    cut = lambda t: list(t.split(24 // sp, dim=3))  # noqa: E731
    for whole, shards in ((mimick_and_swap(sug, codec, 0.3),
                           mimick_and_swap_shards(cut(sug), cut(codec), 0.3, "cpu")),
                          (mimick_plain(sug, codec), mimick_plain_shards(cut(sug), cut(codec), "cpu"))):
        assert torch.equal(torch.cat(shards[0], dim=3), whole[0])
        assert abs(shards[1].item() - whole[1].item()) <= 1e-6 * abs(whole[1].item())
        _close(torch.autograd.grad(shards[1], sug)[0], torch.autograd.grad(whole[1], sug)[0], 1e-6)


# ---------------------------------------------------------------------------
# the Haar net
# ---------------------------------------------------------------------------


def _haar_opt(sp, condition="D2DTNet", scale=4, is_train=True, **val):
    network = dict(HAAR_NET, condition_func=condition, scale=scale, block_num=[1, 1][:{2: 1, 4: 2}[scale]])
    return dict_to_nonedict({"is_train": is_train, "model": "SelfC", "distortion": "sr_bd", "scale": scale,
                             "mesh_sp": sp, "datasets": {"train": {"video_len": 3}}, "val": val,
                             "network_G": network, "path": {}, "train": HAAR_TRAIN})


@functools.lru_cache(maxsize=None)
def _haar_case(condition, scale=4):
    """One seeded tree, clip and eps; the port's sp 1 and sp 2 steps."""
    W = 160 if condition != "D2DTNet" else 8 * scale
    model = RescaleModel(_haar_opt(1, condition, scale), device="cpu")
    tree = _tree_for(model.net, 30)
    x = _rand(31, (1, 3, 16, W, 3))
    eps = _rand(32, model.net.eps_shape((1, 3, 16 // scale, W // scale, 3)), normal=True)
    steps = {}
    for sp in (1, 2):
        steps[sp] = RescaleModel(_haar_opt(sp, condition, scale), device="cpu", mesh=_cpus(sp))
        steps[sp].load_jax_params(tree)
        assert steps[sp].feed_data({"GT": x}) == 3
        steps[sp].optimize_parameters(0, eps=eps)
    return tree, x, eps, steps


@pytest.mark.parametrize("condition", ["D2DTNet", "FeatureCollapse"])
def test_haar_split_step_matches_the_unsplit_step(condition):
    """At 4x: each level's coupling blocks haloed at that level's width,
    the prior's D2DT chains (or FeatureCollapse blocks) haloed, its NLL a
    sum over the shards: the sp 2 step is the unsplit one's."""
    steps = _haar_case(condition)[3]
    got, want = ({k: v for k, v in m.get_current_log().items()} for m in (steps[2], steps[1]))
    assert got["loss_c"] != 0.0
    _assert_steps_match((got, {k: p.grad for k, p in steps[2].net.named_parameters()}),
                        (want, {k: p.grad for k, p in steps[1].net.named_parameters()}),
                        ("loss", "l_forw_fit", "l_back_rec", "loss_c"))


def test_haar_split_step_matches_jax():
    """At 2x (one JAX program; the two-level split is held to the port's
    unsplit step above): the sp 2 step against the JAX
    ``RescaleModel._pixel_losses`` and its ``jax.value_and_grad`` on the
    fed eps."""
    tree, x, eps, steps = _haar_case("D2DTNet", 2)
    jm = JSelfCNetHaar(scale=2, block_num=(1,), stp_temporal_c=8, gmm_mixture_num=2)
    jrm = object.__new__(JRescaleModel)
    jrm.net, jrm.train_opt = jm, jnonedict(HAAR_TRAIN)
    hr = jnp.asarray(x)
    ref_l = jresize.gaussian_downsample(hr, 2)
    (_, logs), grads = jax.jit(jax.value_and_grad(
        lambda p, e: _fed(lambda: jrm._pixel_losses(p, hr, ref_l, jax.random.PRNGKey(0)), e)[:2],
        has_aux=True))(jax.tree.map(jnp.asarray, tree), jnp.asarray(eps))
    got = steps[2].get_current_log()
    assert got["loss_c"] != 0.0
    for k, v in logs.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-5, err_msg=k)
    want, mine = flatten_tree(jax.tree.map(np.asarray, grads)), flatten_tree(export_jax_grads(steps[2].net))
    assert set(mine) == set(want)
    num = sum(((mine[k] - v).astype(np.float64) ** 2).sum() for k, v in want.items())
    den = sum((v.astype(np.float64) ** 2).sum() for v in want.values())
    assert (num / den) ** 0.5 <= 1e-4


def test_haar_split_test_matches_the_unsplit_test():
    """At 4x, ``test()`` with the width of its one-group calls over sp 2: each
    level's Haar step on each shard, the same eps stream, the LR quantised
    once on the master."""
    tree = _haar_case("D2DTNet")[0]
    clip = _rand(33, (1, 7, 16, 32, 3))
    out = []
    for sp in (1, 2):
        model = RescaleModel(_haar_opt(sp, is_train=False, gop_batch=1), device="cpu", mesh=_cpus(sp), rng_seed=4)
        model.load_jax_params(tree)
        model.feed_data({"GT": clip})
        model.test(gop=7)
        out.append((model.forw_L, model.forw_H, model.fake_H, model.sample_H))
    assert np.array_equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1:], out[1][1:]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the widths each split takes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["codec_halo", "codec_grid", "haar_halo", "haar_grid"])
def test_width_errors_name_the_block(case):
    """W must split into whole LR columns that the widest halo fits, on
    the coarsest grid: the codec's surrogate (FeatureCollapse: 20 LR
    columns on a 4-column grid, so 40 HR columns a shard in multiples of
    8), the Haar net's FeatureCollapse prior (80 in multiples of 16)."""
    if case.startswith("codec"):
        model = CodecModel(_train_opt(), device="cpu", mesh=_cpus(2))
        bad, good = (72 if case == "codec_halo" else 88), 80
        block = "surrogate.net_2"
    else:
        model = RescaleModel(_haar_opt(2, "FeatureCollapse"), device="cpu", mesh=_cpus(2))
        bad, good = (144 if case == "haar_halo" else 168), 160
        block = "stp_net.blk1"
    with pytest.raises(ValueError, match=f"whole LR columns.*{block}"):
        model.feed_data({"GT": _rand(0, (1, 3, 16, bad, 3))})
    assert model.feed_data({"GT": _rand(0, (1, 3, 16, good, 3))}) == 3
