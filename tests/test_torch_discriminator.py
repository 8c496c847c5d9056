"""The adversarial branch's parts against the JAX package, fp32, on the CPU:
``gan_loss`` and ``gradient_penalty``, the VGG discriminator (eval and train
mode, the running statistics after two chained train calls), the VGG-19
feature extractor and its torchvision import (the combined step, the
checkpoints and the shipped config are in test_torch_gan.py).

Parameters come from ``jax.eval_shape`` filled with seeded numpy values (no
flax ``init``). Tolerances: a forward 1e-5 absolute; the running statistics
1e-5 relative l2."""

from functools import partial
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.models import discriminator as jdisc
from selfc_tpu.train import losses as jlosses
from selfc_tpu.utils import torch_import as jti
from selfc_tpu_torch.models import discriminator as tdisc
from selfc_tpu_torch.train import losses as tlosses
from selfc_tpu_torch.utils import torch_import as tti
from selfc_tpu_torch.utils.jax_import import flatten_tree, load_jax_params
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


GT, T, NF = 32, 3, 8


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).sum() / max((want ** 2).sum(), 1e-300)))


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


def _port_d(params, stats, size):
    net = tdisc.DiscriminatorVGG128(3, NF, size, device="cpu")
    load_jax_params(net, params)
    return net, {k: {n: torch.from_numpy(v) for n, v in s.items()} for k, s in stats.items()}


def _stats_np(stats):
    return {k: {n: t.numpy() for n, t in s.items()} for k, s in stats.items()}


@pytest.mark.parametrize("real", [True, False], ids=["real", "fake"])
@pytest.mark.parametrize("gan_type", ["gan", "ragan", "lsgan", "wgan-gp"])
def test_gan_loss_matches_jax(gan_type, real):
    z = np.random.default_rng(1).normal(0, 3, (7, 1)).astype(np.float32)
    got = tlosses.gan_loss(torch.from_numpy(z), real, gan_type).item()
    want = float(jlosses.gan_loss(jnp.asarray(z), real, gan_type))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def test_gan_loss_refuses_an_unknown_type():
    with pytest.raises(NotImplementedError):
        tlosses.gan_loss(torch.zeros(2, 1), True, "hinge")


def test_gradient_penalty_matches_jax():
    """On a tiny D (a tanh layer and a sum): the penalty and its gradient
    in D's weight, through ``create_graph``."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (3, 4, 4, 2)).astype(np.float32)
    w = rng.normal(0, 0.5, (2, 5)).astype(np.float32)

    def jax_penalty(wj):
        return jlosses.gradient_penalty(lambda v: jnp.tanh(v @ wj).sum(axis=(1, 2, 3)), jnp.asarray(x))

    want, want_g = jax.value_and_grad(jax_penalty)(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    got = tlosses.gradient_penalty(lambda v: torch.tanh(v @ wt).sum(dim=(1, 2, 3)), torch.from_numpy(x))
    (got_g,) = torch.autograd.grad(got, wt)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert rel_l2(got_g.numpy(), want_g) <= 1e-4


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("size", [32, 36])
def test_discriminator_matches_jax(size, train):
    """Logits, and in train mode the updated running statistics; at 36 the
    k4 s2 convs meet an odd side (9 -> 4), at 32 linear1 reads 1 x 1 x 64.
    Four images: the last norm sees one value an image per channel, and with
    two of them E[x^2] - E[x]^2 keeps only a few bits in either stack."""
    jd, params, stats = _d_tree(NF, size, 3)
    x = _rand(4, (4, size, size, 3))
    net, tstats = _port_d(params, stats, size)
    assert net.linear1.kernel.shape == params["linear1"]["kernel"].shape
    with torch.no_grad():
        got, got_stats = net(torch.from_numpy(x), tstats, train)
    if train:
        want, mut = jax.jit(partial(jd.apply, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
        assert tree_rel_l2(_stats_np(got_stats), mut["batch_stats"]) <= 1e-5
    else:
        want = jax.jit(partial(jd.apply, train=False))({"params": params, "batch_stats": stats}, jnp.asarray(x))
        assert all(got_stats[k] is tstats[k] for k in tstats)   # eval mode keeps the statistics
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_discriminator_chained_train_stats_match_jax():
    """Two train-mode calls chained as D's step chains them (real with the
    running statistics, the fake with what the first returned): flax folds
    the biased batch variance in with momentum 0.9; an unbiased variance
    would be off by a factor 8/7 on the last 2 x 2 x 2 maps."""
    jd, params, stats = _d_tree(NF, GT, 5)
    a, b = _rand(6, (2, GT, GT, 3)), _rand(7, (2, GT, GT, 3))
    apply = jax.jit(partial(jd.apply, train=True, mutable=["batch_stats"]))
    _, m1 = apply({"params": params, "batch_stats": stats}, jnp.asarray(a))
    _, m2 = apply({"params": params, "batch_stats": m1["batch_stats"]}, jnp.asarray(b))
    net, tstats = _port_d(params, stats, GT)
    with torch.no_grad():
        _, s1 = net(torch.from_numpy(a), tstats, True)
        _, s2 = net(torch.from_numpy(b), s1, True)
    assert tree_rel_l2(_stats_np(s2), m2["batch_stats"]) <= 1e-5
    np.testing.assert_allclose(s2["bn4_1"]["var"].numpy(), np.asarray(m2["batch_stats"]["bn4_1"]["var"]),
                               rtol=1e-5)


def _vgg_tree(feature_layer, seed, size=16):
    jf = jdisc.VGGFeatureExtractor(feature_layer=feature_layer)
    return jf, seeded_tree(jf, seed, jnp.zeros((1, size, size, 3)))


def test_vgg_features_match_jax():
    """The whole extractor to conv5_4 (layer 34, no ReLU after it) on 2 x
    16 x 16: four pools leave 1 x 1 x 512."""
    jf, tree = _vgg_tree(34, 8)
    x = _rand(9, (2, 16, 16, 3))
    tf = tdisc.define_F(device="cpu")
    load_jax_params(tf, tree)
    with torch.no_grad():
        got = tf(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jf.apply)({"params": tree}, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 1, 1, 512) and (want < 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_import_vgg19_features_matches_jax():
    """A torchvision-layout ``features.N`` dict (torch tensors) -> the same
    tree as the JAX import; a dict without the keys raises."""
    rng = np.random.default_rng(10)
    sd, c_in = {}, 3
    cfg = [c for c in jdisc._VGG19_CFG if c != "M"]
    for idx, c in zip(jti._VGG19_CONV_IDX, cfg):
        sd[f"features.{idx}.weight"] = torch.from_numpy(rng.normal(0, 1, (c, c_in, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(0, 1, (c,)).astype(np.float32))
        c_in = c
    got = tti.import_vgg19_features(sd)
    want = jti.import_vgg19_features({k: v.numpy() for k, v in sd.items()})
    assert set(got) == set(want) and len(got) == 16
    for k in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[k][leaf], want[k][leaf])
    with pytest.raises(KeyError):
        tti.import_vgg19_features({"classifier.0.weight": np.zeros((2, 2))})
