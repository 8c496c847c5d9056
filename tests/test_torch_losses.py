"""The training slice's pure functions against the JAX package, fp32, on the
CPU: the BD degradation, the losses, the learning-rate schedules, and clip
-> weight decay -> Adam against the optax chain (the step itself is in
test_torch_train.py).

Tolerances: the degradation and losses atol 1e-6; the schedules atol 1e-12;
the optimizer's parameters rtol 1e-5, atol 1e-6 after each of three steps,
the clip's norm rtol 1e-6 of its float64 value."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfc_tpu.ops import resize as jresize
from selfc_tpu.train import losses as jlosses
from selfc_tpu.train import lr_schedule as jsched
from selfc_tpu_torch.ops.resize import gaussian_downsample
from selfc_tpu_torch.train import lr_schedule as tsched
from selfc_tpu_torch.train.losses import reconstruction_loss
from selfc_tpu_torch.train.rescale_model import clip_by_global_norm_, make_degrade


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLIP_SHAPE = (1, 3, 16, 16, 3)


def _clip(seed, shape=CLIP_SHAPE):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


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


def test_clip_norm_of_a_large_leaf_is_the_float64_norm():
    """``clip_by_global_norm_`` on the CPU: the global norm of a 9.3 M-element
    leaf (the size of the codec surrogate's largest) beside a small one
    within 1e-7 of the float64 norm (torch's fp32 norm sums in fp32 on the
    CPU); the clipped gradient's norm is ``max_norm``."""
    g = torch.Generator().manual_seed(8)
    leaves = [torch.rand(9_289_728, generator=g), torch.randn(3, 5, generator=g)]
    params = [torch.nn.Parameter(torch.zeros_like(v)) for v in leaves]
    for p, v in zip(params, leaves):
        p.grad = v.clone()
    exact = float(np.sqrt(sum((v.double() ** 2).sum().item() for v in leaves)))
    norm = clip_by_global_norm_(params, 1.0)
    assert abs(norm.item() - exact) <= 1e-7 * exact
    clipped = float(np.sqrt(sum((p.grad.double() ** 2).sum().item() for p in params)))
    assert abs(clipped - 1.0) <= 1e-6
