"""The training slice of the port against the JAX package, fp32, on the CPU:
the BD degradation, the losses, the schedules, clip -> weight decay -> Adam
against the optax chain, and the slice as a whole (a tiny SelfC_GMM: loss,
the full gradient tree, the parameters after two steps).

Parity is checked on a fed ``eps``, never on a seed: the two stacks' random
generators give different numbers from the same seed.

Tolerances: pure functions atol 1e-6; the loss rtol 1e-5 (a mean over 2,304
values scaled by 62,208); each gradient leaf 1e-3 of that leaf's largest
element (three chains each way, an exp and a quantization between them); the
parameters after each of two Adam steps atol 1e-6, a hundredth of one step's
``lr = 1e-4`` (an element moves by up to ``lr`` a step whatever its
gradient, so a looser limit would say nothing), but for at most 1 element in
1,000 of a leaf, which may differ by up to 1e-5: where the clipped gradient
nearly cancels the weight decay, Adam's normalised update turns on the last
bits of the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
from selfc_tpu.ops import gmm as jgmm
from selfc_tpu.ops import resize as jresize
from selfc_tpu.train import losses as jlosses
from selfc_tpu.train import lr_schedule as jsched
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models.blocks import DenseChain
from selfc_tpu_torch.ops.resize import gaussian_downsample
from selfc_tpu_torch.train import lr_schedule as tsched
from selfc_tpu_torch.train.losses import reconstruction_loss
from selfc_tpu_torch.train.rescale_model import RescaleModel, clip_by_global_norm_, make_degrade
from selfc_tpu_torch.utils.jax_import import export_jax_grads, export_jax_params, flatten_tree
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

TINY = dict(scale=4, block_num=(1,), stp_blk_num=1, gmm_k=5)
CLIP_SHAPE = (1, 3, 16, 16, 3)
TRAIN = {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "weight_decay_G": 1e-2,
         "gradient_clipping": 10, "pixel_criterion_forw": "l2", "pixel_criterion_back": "l1",
         "lambda_fit_forw": 1, "lambda_rec_back": 1, "lambda_cond_prob": 0}


def _opt(train=None, **top):
    return dict_to_nonedict({
        "model": "SelfC_GMM", "scale": 4, "is_train": True, "distortion": "sr_bd",
        "network_G": {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1],
                      "stp_blk_num": 1, "gmm_k": 5},
        "train": dict(TRAIN, **(train or {})), **top})


def _clip(seed, shape=CLIP_SHAPE):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale,shape", [(4, (1, 2, 32, 40, 3)), (2, (2, 16, 24, 3)), (3, (1, 18, 18, 1))])
def test_gaussian_downsample_matches_jax(scale, shape):
    x = _clip(0, shape)
    want = jresize.gaussian_downsample(jnp.asarray(x), scale)
    got = gaussian_downsample(torch.from_numpy(x), scale)
    assert tuple(got.shape) == tuple(want.shape) == shape[:-3] + (shape[-3] // scale, shape[-2] // scale, shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_gaussian_downsample_rejects_other_scales():
    with pytest.raises(ValueError):
        gaussian_downsample(torch.zeros(1, 40, 40, 3), 5)


@pytest.mark.parametrize("distortion", ["sr_bd", "pytorch_bicubic"])
def test_make_degrade_matches_jax(distortion):
    from selfc_tpu.train.rescale_model import make_degrade as jmake
    x = _clip(1, (1, 2, 32, 32, 3))
    np.testing.assert_allclose(make_degrade(distortion, 4)(torch.from_numpy(x)).numpy(),
                               np.asarray(jmake(distortion, 4)(jnp.asarray(x))), atol=1e-6)


def test_make_degrade_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="A25"):
        make_degrade("matlab", 4)
    with pytest.raises(ValueError):
        make_degrade("nearest", 4)


@pytest.mark.parametrize("losstype", ["l2", "l1"])
def test_reconstruction_loss_matches_jax(losstype):
    a, b = _clip(2, (2, 3, 8, 8, 3)), _clip(3, (2, 3, 8, 8, 3))
    b[0, 0] = a[0, 0]  # exact zeros of the difference: the charbonnier eps
    want = jlosses.reconstruction_loss(jnp.asarray(a), jnp.asarray(b), losstype)
    got = reconstruction_loss(torch.from_numpy(a), torch.from_numpy(b), losstype)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
    with pytest.raises(ValueError):
        reconstruction_loss(torch.zeros(1), torch.zeros(1), "huber")


STEPS = [0, 1, 9, 10, 11, 49, 50, 51, 99, 100, 101, 149, 150, 199, 200, 250, 399]


@pytest.mark.parametrize("kw", [
    dict(milestones=[50, 100, 150], gamma=0.5),
    dict(milestones=[50, 150, 250], gamma=0.3, restarts=[100, 200], restart_weights=[0.5, 0.25]),
    dict(milestones=[], warmup_iter=10),
    dict(milestones=None, restarts=[100], restart_weights=None, warmup_iter=50),
])
def test_multistep_restart_matches_jax(kw):
    want, got = jsched.multistep_restart(2e-4, **kw), tsched.multistep_restart(2e-4, **kw)
    np.testing.assert_allclose([got(s) for s in STEPS], [want(s) for s in STEPS], rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(t_period=[100, 100, 200], restarts=[100, 200], restart_weights=[1, 0.5]),
    dict(t_period=[400], eta_min=1e-6),
    dict(t_period=[150, 150], restarts=[150], restart_weights=[0.7], warmup_iter=20),
])
def test_cosine_restart_matches_jax(kw):
    want, got = jsched.cosine_restart(2e-4, **kw), tsched.cosine_restart(2e-4, **kw)
    np.testing.assert_allclose([got(s) for s in STEPS], [want(s) for s in STEPS], rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the optimizer: clip -> weight decay -> Adam, against the optax chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip,wd", [(10.0, 0.1), (0.5, 0.0), (1e6, 1e-14)])
def test_clip_decay_adam_matches_optax_chain(clip, wd):
    """Three steps on a hand-made tree with hand-made gradients: the chain of
    selfc_tpu/train/rescale_model.py (clip_by_global_norm ->
    add_decayed_weights -> scale_by_adam, then p - lr * u) against
    ``clip_by_global_norm_`` + ``torch.optim.Adam(weight_decay=wd)``. Order,
    eps placement and bias correction all show by the third step."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 3, 5, 4), "b": (4,), "c": (7, 2)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 10.0 ** (i - 1), s)).astype(np.float32) for k, s in shapes.items()}
             for i in range(3)]
    grads[1]["b"][:] = 0.0  # a zero gradient: only eps keeps the update finite
    lrs = [1e-2, 5e-3, 2e-2]

    tx = optax.chain(optax.clip_by_global_norm(clip),
                     *([optax.add_decayed_weights(wd)] if wd else []),
                     optax.scale_by_adam(b1=0.9, b2=0.999))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = torch.optim.Adam(tp.values(), lr=1.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    for g, lr in zip(grads, lrs):
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda p, u: p - lr * u, jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = clip_by_global_norm_(list(tp.values()), clip)
        np.testing.assert_allclose(norm.item(), np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())), rtol=1e-6)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_pair():
    """Two training steps through both stacks from the same parameters,
    batch and noise. JAX side: ``jax.value_and_grad`` over the loss assembly
    of selfc_tpu/train/rescale_model.py (``_pixel_losses``) and its optax
    chain."""
    x = _clip(5)
    jm = JSelfCNetGMM(**TINY)
    tree = seeded_tree(jm, 6, jnp.asarray(x), method=jm.roundtrip)
    eps = [np.random.default_rng(7 + i).normal(0, 1, (1, 3, 4, 4, 48, 5)).astype(np.float32) for i in range(2)]
    ref_l = jresize.gaussian_downsample(jnp.asarray(x), 4)

    def loss_fn(params, e):
        saved = jgmm.sample_normal
        jgmm.sample_normal = lambda rng, shape, dtype: e
        try:
            out = jm.apply({"params": params}, jnp.asarray(x), method=jm.roundtrip,
                           rngs={"sample": jax.random.PRNGKey(0)})
        finally:
            jgmm.sample_normal = saved
        l_forw = jlosses.reconstruction_loss(out["lr_pre_quant"], ref_l, "l2")
        l_back = jlosses.reconstruction_loss(out["hr"], jnp.asarray(x), "l1")
        loss = (l_forw + l_back + 0.0 * out["loss_c"]) * 144 * 144 * 3
        return loss, {"l_forw_fit": l_forw, "l_back_rec": l_back, "loss": loss}

    tx = optax.chain(optax.clip_by_global_norm(TRAIN["gradient_clipping"]),
                     optax.add_decayed_weights(TRAIN["weight_decay_G"]),
                     optax.scale_by_adam(b1=0.9, b2=0.999))
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    jax_steps = []
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))  # eager costs 50 s, jit 11
    for e in eps:
        (_, logs), grads = value_and_grad(jp, jnp.asarray(e))
        updates, state = tx.update(grads, state, jp)
        jp = jax.tree.map(lambda p, u: p - TRAIN["lr_G"] * u, jp, updates)
        jax_steps.append({"logs": {k: float(v) for k, v in logs.items()},
                          "grads": jax.tree.map(np.asarray, grads),
                          "params": jax.tree.map(np.asarray, jp)})

    model = RescaleModel(_opt(), device="cpu")
    model.load_jax_params(tree)
    assert model.feed_data({"GT": x}) == 3
    port_steps = []
    for i, e in enumerate(eps):
        model.optimize_parameters(i, eps=e)
        port_steps.append({"logs": dict(model.get_current_log()),
                           "grad_norm": float(model.grad_norm),
                           "grads": export_jax_grads(model.net),
                           "params": export_jax_params(model.net)})
    return jax_steps, port_steps, model, tree, x, eps


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_logs_match_jax(slice_pair, step):
    jax_steps, port_steps = slice_pair[:2]
    logs = port_steps[step]["logs"]
    assert set(logs) == {"l_forw_fit", "l_back_rec", "loss_c", "loss", "skipped_nonfinite", "lr"}
    for k, want in jax_steps[step]["logs"].items():
        np.testing.assert_allclose(logs[k], want, rtol=1e-5)
    assert logs["loss_c"] == 0.0 and logs["skipped_nonfinite"] == 0.0 and logs["lr"] == 1e-4


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_gradient_tree_matches_jax(slice_pair, step):
    """Leaf by leaf, before clipping on the JAX side and after it on the
    port's (``.grad`` is clipped in place), so the port's leaves are scaled
    back by norm / clip."""
    jax_steps, port_steps = slice_pair[:2]
    want = flatten_tree(jax_steps[step]["grads"])
    got = flatten_tree(port_steps[step]["grads"])
    assert set(got) == set(want)
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in want.values()))
    np.testing.assert_allclose(port_steps[step]["grad_norm"], norm, rtol=1e-4)
    assert norm > TRAIN["gradient_clipping"]  # the clip is active in this test
    top = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        # a leaf whose gradient is zero by construction (the bias of the
        # attention's key projection: softmax does not see it) holds
        # rounding noise on both sides
        scale = top if np.abs(v).max() < 1e-6 * top else np.abs(v).max()
        np.testing.assert_allclose(got[k] * (norm / TRAIN["gradient_clipping"]), v,
                                   rtol=0, atol=1e-3 * scale, err_msg=k)
    # every conv of the chains receives gradient (none is blind)
    chain_leaves = [k for k in want if ".chain.conv" in k]
    assert chain_leaves and all(np.abs(got[k]).max() > 0 for k in chain_leaves)


@pytest.mark.parametrize("step", [0, 1])
def test_parameters_after_step_match_jax(slice_pair, step):
    jax_steps, port_steps, _, tree = slice_pair[:4]
    want = flatten_tree(jax_steps[step]["params"])
    got = flatten_tree(port_steps[step]["params"])
    start = flatten_tree(tree)
    for k, v in want.items():
        diff = np.abs(got[k] - v)
        assert diff.max() <= 1e-5 and (diff > 1e-6).mean() <= 1e-3, (k, diff.max(), (diff > 1e-6).mean())
        assert np.abs(got[k] - start[k]).max() > 1e-5, f"{k} did not move"


def test_train_step_same_with_recomputed_feats(slice_pair):
    _, port_steps, _, tree, x, eps = slice_pair
    model = RescaleModel(_opt({"save_chain_feats": False}), device="cpu")
    chains = [m for m in model.net.modules() if isinstance(m, DenseChain)]
    assert len(chains) == 5 and not any(m.save_feats for m in chains)
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, eps=eps[0])
    assert dict(model.get_current_log()) == port_steps[0]["logs"]
    for k, v in flatten_tree(export_jax_params(model.net)).items():
        np.testing.assert_array_equal(v, flatten_tree(port_steps[0]["params"])[k])


def test_nonfinite_loss_skips_the_update(slice_pair):
    _, _, _, tree, x, eps = slice_pair
    model = RescaleModel(_opt(), device="cpu")
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, eps=eps[0])
    before = flatten_tree(export_jax_params(model.net))
    moments = {k: v.clone() for s in model.optimizer.state.values() for k, v in s.items()}
    bad = x.copy()
    bad[0, 0, 0, 0, 0] = np.inf
    model.feed_data({"GT": bad})
    model.optimize_parameters(1, eps=eps[1])
    logs = model.get_current_log()
    assert logs["skipped_nonfinite"] == 1.0 and not np.isfinite(logs["loss"])
    for k, v in flatten_tree(export_jax_params(model.net)).items():
        np.testing.assert_array_equal(v, before[k])
    after = {k: v for s in model.optimizer.state.values() for k, v in s.items()}
    assert all(torch.equal(after[k], moments[k]) for k in moments)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "serve"])
def test_checkpoint_path_raises_naming_a18(monkeypatch, is_train):
    """``path.pretrain_model_G`` names a checkpoint the port cannot load yet:
    the wrapper raises (ROADMAP A18) before it builds a net, where it would
    otherwise serve or train random weights without a word."""
    from selfc_tpu_torch.train import rescale_model

    def no_net(*args, **kwargs):
        raise AssertionError("a net was built before the checkpoint path was refused")
    monkeypatch.setattr(rescale_model, "define_G", no_net)
    opt = _opt(path={"pretrain_model_G": "SelfC_GMM.pth"}, is_train=is_train)
    opt["network_G"]["block_num"] = [1, 1]
    with pytest.raises(NotImplementedError, match="A18"):
        RescaleModel(opt, device="cpu")


def test_unported_training_options_raise():
    with pytest.raises(NotImplementedError, match="A25"):
        RescaleModel(_opt({"gan_weight": 0.01}), device="cpu")
    with pytest.raises(NotImplementedError, match="A25"):
        RescaleModel(_opt(distortion="matlab"), device="cpu")
    with pytest.raises(NotImplementedError):
        RescaleModel(_opt({"lr_scheme": "OneCycle"}), device="cpu")
    serving = _opt()
    serving["is_train"] = False
    with pytest.raises(RuntimeError, match="is_train"):
        RescaleModel(serving, device="cpu").optimize_parameters(0)


def test_clear_state_and_schedule_and_fused_flag():
    """Moments are cleared at a restart step under train.clear_state; the
    rate follows the schedule; train.fused_optimizer is accepted and is the
    same optimizer."""
    opt = _opt({"lr_scheme": "MultiStepLR", "lr_steps": [2], "lr_gamma": 0.5,
                "restarts": [3], "restart_weights": [0.5], "clear_state": True,
                "fused_optimizer": True})
    model = RescaleModel(opt, device="cpu", rng_seed=3)
    model.feed_data({"GT": _clip(8)})
    lrs, steps_seen = [], []
    for step in range(4):
        model.optimize_parameters(step)
        lrs.append(model.get_current_log()["lr"])
        steps_seen.append(int(next(iter(model.optimizer.state.values()))["step"]))
    np.testing.assert_allclose(lrs, [1e-4, 1e-4, 5e-5, 5e-5], rtol=1e-12)
    assert steps_seen == [1, 2, 3, 1]  # cleared before the step at the restart


def test_feed_data_pads_to_video_len_and_draws_its_own_noise():
    opt = _opt(datasets={"train": {"video_len": 5}})
    model = RescaleModel(opt, device="cpu", rng_seed=1)
    assert model.feed_data({"GT": _clip(9)}) == 3
    assert tuple(model.real_H.shape) == (1, 5, 16, 16, 3)
    assert torch.equal(model.real_H[:, 4], model.real_H[:, 2])
    model.optimize_parameters(0)   # eps from the model's generator
    assert np.isfinite(model.get_current_log()["loss"])
    u8 = (np.asarray(_clip(9)) * 255).astype(np.uint8)
    model.feed_data({"GT": u8})
    assert model.real_H.dtype == torch.float32 and float(model.real_H.max()) <= 1.0


def test_mixed_precision_step_keeps_fp32_masters(slice_pair):
    _, port_steps, _, tree, x, eps = slice_pair
    model = RescaleModel(_opt({"mixed_precision": True}), device="cpu")
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, eps=eps[0])
    logs = model.get_current_log()
    # bf16 activations: the loss agrees with the fp32 step's to bf16 accuracy
    np.testing.assert_allclose(logs["loss"], port_steps[0]["logs"]["loss"], rtol=5e-2)
    for p in model.net.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert torch.isfinite(p).all()


def test_visuals_carry_the_lr_target(slice_pair):
    model, x = slice_pair[2], slice_pair[4]
    model.test(gop=3)
    vis = model.get_current_visuals()
    assert list(vis) == ["SR", "LR", "LR_ref", "GT", "forw_H"]
    np.testing.assert_allclose(vis["LR_ref"], np.asarray(jresize.gaussian_downsample(jnp.asarray(x), 4)), atol=1e-6)
