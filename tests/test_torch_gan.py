"""The adversarial branch of the port against the JAX package, fp32, on the
CPU (its losses and nets: test_torch_discriminator.py): one combined G + D step
against ``AdversarialBranch.train_step`` ('ragan' with the feature loss,
'wgan-gp' with JAX's interpolation weights fed), the update gating and the
non-finite guard, D's checkpoint and the ``.state`` extras crossing both
ways, and the shipped ``train_rescaling_gan.yml`` through ``create_model``.

Parameters come from ``jax.eval_shape`` filled with seeded numpy values (no
flax ``init``); the prior's noise is fed to both stacks. Tolerances: a
forward 1e-5 absolute; a step's parameters, Adam moments, running statistics
and logs 1e-4 relative l2 (the port's usual limits for a step); a
checkpoint's values bit for bit.
"""

import os
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfc_tpu.config import dict_to_nonedict as jnonedict
from selfc_tpu.models import discriminator as jdisc
from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
from selfc_tpu.ops import gmm as jgmm
from selfc_tpu.train import checkpoint as jckpt
from selfc_tpu.train.gan import AdversarialBranch as JBranch
from selfc_tpu.train.rescale_model import RescaleModel as JRescaleModel
from selfc_tpu.train.rescale_model import make_degrade as jmake_degrade
from selfc_tpu_torch.config import dict_to_nonedict, parse
from selfc_tpu_torch.models import discriminator as tdisc
from selfc_tpu_torch.train import checkpoint as ckpt
from selfc_tpu_torch.train import create_model
from selfc_tpu_torch.train.rescale_model import RescaleModel
from selfc_tpu_torch.utils.jax_import import export_jax_params, flatten_tree, load_jax_params
from test_torch_models import seeded_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GT, T, NF = 32, 3, 8
TRAIN = {"lr_G": 1e-4, "lr_D": 2e-4, "beta1": 0.9, "beta2": 0.999, "beta1_D": 0.5, "beta2_D": 0.99,
         "lr_scheme": "MultiStepLR", "lr_steps": [], "lr_gamma": 0.5,
         "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1", "lambda_fit_forw": 1,
         "lambda_rec_back": 1, "gradient_clipping": 10, "gan_type": "gan", "gan_weight": 5e-3,
         "D_update_ratio": 1, "D_init_iters": 0}
# G is cut below the JAX package's own GAN tests (block_num [1, 1], STP 2): the
# JAX step's compile is most of this file's time
NET_G = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1], "scale": 4, "init": "xavier",
         "global_module": "nonlocal", "stp_blk_num": 1, "fh_loss": "gmm", "gmm_k": 2}
STEP = 1


def _opt_dict(**train):
    return {"is_train": True, "model": "SelfC_GMM", "distortion": "sr_bd", "scale": 4,
            "datasets": {"train": {"video_len": T, "GT_size": GT}}, "network_G": dict(NET_G),
            "network_D": {"which_model_D": "discriminator_vgg_128", "in_nc": 3, "nf": NF},
            "path": {}, "train": dict(TRAIN, **train)}


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def tree_rel_l2(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:5]
    num = sum(((np.asarray(g[k], np.float64) - np.asarray(w[k], np.float64)) ** 2).sum() for k in w)
    den = sum((np.asarray(w[k], np.float64) ** 2).sum() for k in w)
    return float(np.sqrt(num / den))


def _d_tree(nf, size, seed):
    """D's params and batch stats from ``eval_shape``, seeded: batch-norm
    scales near 1, running variances in [0.5, 1.5]."""
    jd = jdisc.DiscriminatorVGG128(in_nc=3, nf=nf)
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=True))
    rng = np.random.default_rng(seed)
    params = {}
    for name, leaves in shapes["params"].items():
        params[name] = {}
        for leaf, s in leaves.items():
            if name.startswith("bn") and leaf == "scale":
                v = 1.0 + rng.normal(0, 0.1, s.shape)
            elif len(s.shape) == 1:
                v = rng.normal(0, 0.05, s.shape)
            else:
                v = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
            params[name][leaf] = v.astype(np.float32)
    stats = {name: {"mean": rng.normal(0, 0.1, s["mean"].shape).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
             for name, s in shapes["batch_stats"].items()}
    return jd, params, stats


def _vgg_tree(feature_layer, seed, size=16):
    jf = jdisc.VGGFeatureExtractor(feature_layer=feature_layer)
    return jf, seeded_tree(jf, seed, jnp.zeros((1, size, size, 3)))


# ---------------------------------------------------------------------------
# the combined step
# ---------------------------------------------------------------------------


def _jax_g():
    return JSelfCNetGMM(scale=4, block_num=tuple(NET_G["block_num"]), stp_blk_num=NET_G["stp_blk_num"], gmm_k=2)


def _jax_step(gan_type, fea_w, g_tree, d_params, d_stats, f_tree, x, e):
    """``AdversarialBranch.train_step`` of the JAX package, jitted, on a
    model and branch whose fields are set here (no flax ``init``)."""
    jopt = jnonedict(_opt_dict(gan_type=gan_type, feature_weight=fea_w))
    jm = object.__new__(JRescaleModel)
    jm.opt, jm.train_opt, jm.scale = jopt, jopt["train"], 4
    jm.net = _jax_g()
    jm.degrade = jmake_degrade("sr_bd", 4)
    jm._step_key = jax.random.PRNGKey(11)
    jm.tx = optax.chain(optax.clip_by_global_norm(10.0), optax.scale_by_adam(b1=0.9, b2=0.999))
    jb = object.__new__(JBranch)
    jb.gan_type, jb.gan_w, jb.fea_w, jb.fea_crit, jb.gp_w = gan_type, 5e-3, fea_w, "l1", 10.0
    jb.d_update_ratio, jb.d_init_iters = 1, 0
    jb.netD = jdisc.DiscriminatorVGG128(in_nc=3, nf=NF)
    jb.netF = jdisc.VGGFeatureExtractor(feature_layer=4) if fea_w else None
    jb.txD = optax.chain(optax.clip_by_global_norm(10.0), optax.scale_by_adam(b1=0.5, b2=0.99))
    g = jax.tree.map(jnp.asarray, g_tree)
    d = jax.tree.map(jnp.asarray, d_params)
    g_state, d_state = jm.tx.init(g), jb.txD.init(d)
    saved = jgmm.sample_normal
    jgmm.sample_normal = lambda rng, shape, dtype: jnp.asarray(e)
    try:
        out = jax.jit(partial(jb.train_step, jm))(
            g, g_state, d, jax.tree.map(jnp.asarray, d_stats), d_state, f_tree, jnp.asarray(x),
            jnp.float32(1e-4), jnp.float32(2e-4), jnp.int32(STEP))
    finally:
        jgmm.sample_normal = saved
    rng = jax.random.fold_in(jm._step_key, STEP)
    gp_eps = np.asarray(jax.random.uniform(jax.random.fold_in(rng, 1), (T, 1, 1, 1)))
    return jax.tree.map(np.asarray, out), gp_eps, jb, (g_state, d_state)


@pytest.fixture(scope="module", params=["ragan", "wgan-gp"])
def step_pair(request):
    """One combined step through both stacks from the same G, D, F, running
    statistics, batch and noise: 'ragan' with the feature loss (F cut to
    VGG's layer 4 on both sides at this size), 'wgan-gp' without, JAX's
    interpolation weights fed to the port."""
    gan_type = request.param
    fea_w = 1.0 if gan_type == "ragan" else 0.0
    x = _rand(12, (1, T, GT, GT, 3))
    g_tree = seeded_tree(_jax_g(), 13, jnp.asarray(x), method=JSelfCNetGMM.roundtrip)
    _, d_params, d_stats = _d_tree(NF, GT, 14)
    f_tree = _vgg_tree(4, 15, GT)[1] if fea_w else {}
    e = np.random.default_rng(16).normal(0, 1, (1, T, GT // 4, GT // 4, 48, 2)).astype(np.float32)
    want, gp_eps, jb, init_states = _jax_step(gan_type, fea_w, g_tree, d_params, d_stats, f_tree, x, e)

    model = RescaleModel(dict_to_nonedict(_opt_dict(gan_type=gan_type, feature_weight=fea_w)), device="cpu")
    model.load_jax_params(g_tree)
    load_jax_params(model.gan.netD, d_params)
    model.gan.load_stats(d_stats)
    if fea_w:
        model.gan.netF = tdisc.VGGFeatureExtractor(feature_layer=4, device="cpu").requires_grad_(False)
        load_jax_params(model.gan.netF, f_tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(STEP, eps=e, gp_eps=gp_eps if gan_type == "wgan-gp" else None)
    return dict(want=want, model=model, jb=jb, init_states=init_states, trees=(g_tree, d_params, d_stats, f_tree),
                x=x, e=e, gan_type=gan_type)


def test_gan_step_logs_match_jax(step_pair):
    logs = step_pair["model"].get_current_log()
    want = step_pair["want"][5]
    keys = {"l_forw_fit", "l_back_rec", "loss_c", "loss", "l_g_gan", "l_d", "D_real", "D_fake",
            "skipped_nonfinite"} | ({"l_g_fea"} if step_pair["gan_type"] == "ragan" else set())
    assert set(want) == keys and set(logs) == keys | {"lr"}
    for k in keys:
        # D_real / D_fake are means of D's logits, which nearly cancel: held
        # at the forward's absolute limit
        tol = 1e-5 if k in ("D_real", "D_fake") else 1e-4 * max(abs(float(want[k])), 1e-6)
        assert abs(logs[k] - float(want[k])) <= tol, (k, logs[k], want[k])
    assert logs["skipped_nonfinite"] == 0.0


def test_gan_step_generator_matches_jax(step_pair):
    """G's parameters and Adam moments after the step."""
    model, want = step_pair["model"], step_pair["want"]
    assert tree_rel_l2(export_jax_params(model.net), want[0]) <= 1e-4
    st = ckpt.adam_state(model.optimizer, model.net.named_parameters())
    adam = want[1][-1]
    assert st["count"] == int(adam.count) == 1
    assert tree_rel_l2(st["mu"], adam.mu) <= 1e-4 and tree_rel_l2(st["nu"], adam.nu) <= 1e-4


def test_gan_step_discriminator_matches_jax(step_pair):
    """D's parameters, its Adam moments (beta1_D 0.5, beta2_D 0.99) and its
    running statistics after the step."""
    model, want = step_pair["model"], step_pair["want"]
    gan = model.gan
    assert tree_rel_l2(export_jax_params(gan.netD), want[2]) <= 1e-4
    assert tree_rel_l2(gan.stats_numpy(), want[3]) <= 1e-4
    st = ckpt.adam_state(gan.optimizer, gan.netD.named_parameters())
    adam = want[4][-1]
    assert st["count"] == int(adam.count) == 1
    assert tree_rel_l2(st["mu"], adam.mu) <= 1e-4 and tree_rel_l2(st["nu"], adam.nu) <= 1e-4
    assert tree_rel_l2(export_jax_params(gan.netD), step_pair["trees"][1]) > 1e-4   # D moved


def _gan_model(trees, x, **train):
    g_tree, d_params, d_stats, _ = trees
    model = RescaleModel(dict_to_nonedict(_opt_dict(gan_type="lsgan", **train)), device="cpu")
    model.load_jax_params(g_tree)
    load_jax_params(model.gan.netD, d_params)
    model.gan.load_stats(d_stats)
    model.feed_data({"GT": x})
    return model


def _bits(model):
    g = {k: p.detach().clone() for k, p in model.net.named_parameters()}
    d = {k: p.detach().clone() for k, p in model.gan.netD.named_parameters()}
    moments = {id(p): {k: v.clone() for k, v in s.items()} for p, s in model.optimizer.state.items()}
    return g, d, moments


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_gan_step_gating_keeps_g_bits(step_pair):
    """D_update_ratio 2, D_init_iters 2: steps 1 (odd) and 2 (not past the
    warm-up) leave G's parameters and moments the same bits while D moves;
    step 4 updates G."""
    model = _gan_model(step_pair["trees"], step_pair["x"], D_update_ratio=2, D_init_iters=2)
    model.optimize_parameters(0, eps=step_pair["e"])       # 0 is not past D_init_iters either
    g0, d0, m0 = _bits(model)
    for step in (1, 2):
        model.optimize_parameters(step, eps=step_pair["e"])
        g, d, m = _bits(model)
        assert _same(g, g0) and m == m0 == {} and not _same(d, d0)
        assert model.get_current_log()["skipped_nonfinite"] == 0.0
        d0 = d
    model.optimize_parameters(4, eps=step_pair["e"])
    assert not _same(_bits(model)[0], g0)


def test_gan_step_nonfinite_guard(step_pair):
    """A non-finite clip skips both updates: G's and D's parameters, their
    moments and D's running statistics keep their bits."""
    model = _gan_model(step_pair["trees"], step_pair["x"])
    model.optimize_parameters(1, eps=step_pair["e"])
    g0, d0, _ = _bits(model)
    opt_d = {id(p): {k: v.clone() for k, v in s.items()} for p, s in model.gan.optimizer.state.items()}
    stats = model.gan.stats_numpy()
    bad = step_pair["x"].copy()
    bad[0, 0, 0, 0, 0] = np.inf
    model.feed_data({"GT": bad})
    model.optimize_parameters(2, eps=step_pair["e"])
    logs = model.get_current_log()
    assert logs["skipped_nonfinite"] == 1.0 and not np.isfinite(logs["l_d"])
    g, d, _ = _bits(model)
    assert _same(g, g0) and _same(d, d0)
    assert {id(p): {k: v for k, v in s.items()} for p, s in model.gan.optimizer.state.items()}.keys() == opt_d.keys()
    assert all(torch.equal(model.gan.optimizer.state[p][k], opt_d[id(p)][k])
               for p in model.gan.optimizer.state for k in opt_d[id(p)])
    assert tree_rel_l2(model.gan.stats_numpy(), stats) == 0.0


# ---------------------------------------------------------------------------
# checkpoints: D and the .state extras, both ways
# ---------------------------------------------------------------------------


def test_jax_d_and_state_load_in_the_port(step_pair, tmp_path):
    """D's msgpack and a ``.state`` written by the JAX package's checkpoint
    functions (its optax states, its running statistics) load into the
    port bit for bit."""
    want = step_pair["want"]
    jckpt.save_network(want[2], str(tmp_path / "models"), 7, "D")
    state = jckpt.save_training_state(str(tmp_path / "state"), 0, 7, want[1],
                                      extra={"d_opt_state": want[4], "d_stats": want[3]})
    opt = _opt_dict(gan_type=step_pair["gan_type"])
    opt["path"] = {"pretrain_model_D": str(tmp_path / "models" / "7_D.msgpack")}
    model = RescaleModel(dict_to_nonedict(opt), device="cpu")
    for k, v in flatten_tree(want[2]).items():
        np.testing.assert_array_equal(flatten_tree(export_jax_params(model.gan.netD))[k], v, err_msg=k)
    model.resume_training(state)
    st = ckpt.adam_state(model.gan.optimizer, model.gan.netD.named_parameters())
    assert st["count"] == 1
    assert tree_rel_l2(st["mu"], want[4][-1].mu) == 0.0 and tree_rel_l2(st["nu"], want[4][-1].nu) == 0.0
    assert tree_rel_l2(model.gan.stats_numpy(), want[3]) == 0.0


def test_port_d_and_state_load_in_jax(step_pair, tmp_path):
    """The port's ``{iter}_D.msgpack`` reads back through the JAX package's
    ``load_network``; its ``.state`` extras unpickle as optax's own chain
    state, with the structure of ``txD.init`` and the port's moments, and
    ``txD.update`` takes it."""
    model = step_pair["model"]
    model.opt["path"] = {"models": str(tmp_path / "models"), "training_state": str(tmp_path / "state")}
    model.save(7)
    path = model.save_training_state(0, 7)
    d_tree = export_jax_params(model.gan.netD)
    got = jckpt.load_network(str(tmp_path / "models" / "7_D.msgpack"), d_tree)
    assert tree_rel_l2(got, d_tree) == 0.0
    with open(path, "rb") as f:
        extra = pickle.load(f)["extra"]
    d_state = extra["d_opt_state"]
    init_d_state = step_pair["init_states"][1]
    assert jax.tree.structure(d_state) == jax.tree.structure(init_d_state)
    assert type(d_state[-1]) is optax.ScaleByAdamState and int(d_state[-1].count) == 1
    st = ckpt.adam_state(model.gan.optimizer, model.gan.netD.named_parameters())
    assert tree_rel_l2(d_state[-1].mu, st["mu"]) == 0.0
    assert tree_rel_l2(extra["d_stats"], model.gan.stats_numpy()) == 0.0
    grads = jax.tree.map(jnp.ones_like, jax.tree.map(jnp.asarray, d_tree))
    _, new_state = jax.jit(step_pair["jb"].txD.update)(grads, jax.tree.map(jnp.asarray, d_state), grads)
    assert int(new_state[-1].count) == 2


# ---------------------------------------------------------------------------
# the shipped config
# ---------------------------------------------------------------------------


def test_shipped_gan_config_trains_a_step(tmp_path, monkeypatch):
    """``train_rescaling_gan.yml`` as shipped ('ragan', the feature loss on
    VGG-19 to conv5_4, D by ``network_D``) through ``create_model``, cut
    to a test size (one coupling block, one prior block, D at nf 8, 32 px
    crops of 3 frames), with ``path.pretrain_model_F`` a torchvision-layout
    ``.pth`` of VGG-19's first two convs (read with ``weights_only``; the
    later convs keep their init): one step's losses are finite and both nets
    move."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(18)
    vgg = {"features.0.weight": rng.normal(0, 0.3, (64, 3, 3, 3)), "features.0.bias": rng.normal(0, 0.1, 64),
           "features.2.weight": rng.normal(0, 0.05, (64, 64, 3, 3)), "features.2.bias": rng.normal(0, 0.1, 64)}
    torch.save({k: torch.from_numpy(v.astype(np.float32)) for k, v in vgg.items()}, tmp_path / "vgg19.pth")
    opt = parse(os.path.join(ROOT, "selfc_tpu", "configs", "train", "train_rescaling_gan.yml"))
    opt["path"]["pretrain_model_F"] = str(tmp_path / "vgg19.pth")
    assert opt["train"]["gan_type"] == "ragan" and opt["train"]["feature_weight"] == 1.0
    opt["network_G"]["block_num"], opt["network_G"]["stp_blk_num"] = [1], 1
    opt["network_D"]["nf"] = NF
    opt["datasets"]["train"]["GT_size"], opt["datasets"]["train"]["video_len"] = GT, T
    model = create_model(opt, device="cpu")
    assert model.gan is not None and model.gan.netF.feature_layer == 34
    np.testing.assert_array_equal(model.gan.netF.conv_1.kernel.detach().numpy(),
                                  vgg["features.2.weight"].astype(np.float32).transpose(2, 3, 1, 0))
    d0 = {k: p.detach().clone() for k, p in model.gan.netD.named_parameters()}
    model.feed_data({"GT": _rand(17, (1, T, GT, GT, 3))})
    model.optimize_parameters(1)
    logs = model.get_current_log()
    assert all(np.isfinite(v) for v in logs.values()) and logs["l_g_fea"] > 0, logs
    assert any(not torch.equal(p, d0[k]) for k, p in model.gan.netD.named_parameters())
