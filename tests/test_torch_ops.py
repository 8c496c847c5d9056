"""The port's plain ops (selfc_tpu_torch.ops) against the JAX package's, on
the same numpy inputs, fp32, on the CPU. atol 1e-6: these are reorderings,
means over at most a few hundred values and single small products, so only
the last bit of a sum's order can differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.ops import conv as jconv
from selfc_tpu.ops import freq as jfreq
from selfc_tpu.ops import gmm as jgmm
from selfc_tpu.ops import quantize as jquant
from selfc_tpu.ops import resize as jresize
from selfc_tpu.ops import shuffle as jshuffle
from selfc_tpu_torch.ops import conv as tconv
from selfc_tpu_torch.ops import freq as tfreq
from selfc_tpu_torch.ops import gmm as tgmm
from selfc_tpu_torch.ops import quantize as tquant
from selfc_tpu_torch.ops import resize as tresize
from selfc_tpu_torch.ops import shuffle as tshuffle

ATOL = 1e-6


def _rand(seed, shape, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("k", [2, 4])
def test_freq_forward(k):
    x = _rand(0, (1, 2, 8, 16, 3))
    _close(tfreq.freq_forward(torch.from_numpy(x), k),
           jfreq.freq_forward(jnp.asarray(x), k))


@pytest.mark.parametrize("k", [2, 4])
def test_freq_inverse(k):
    y = _rand(1, (1, 2, 4, 3, 3 * (k * k + 1)))
    _close(tfreq.freq_inverse(torch.from_numpy(y), k),
           jfreq.freq_inverse(jnp.asarray(y), k))


@pytest.mark.parametrize("name", ["space_to_depth", "depth_to_space_std"])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_shuffles(name, S):
    shape = (2, 12, 24, 5) if name.startswith("space") else (2, 3, 2, 5 * S * S)
    x = _rand(2, shape)
    _close(getattr(tshuffle, name)(torch.from_numpy(x), S),
           getattr(jshuffle, name)(jnp.asarray(x), S), atol=0)


@pytest.mark.parametrize("k", [2, 4])
def test_area_down_up(k):
    x = _rand(3, (1, 2, 8, 12, 3))
    _close(tresize.area_down(torch.from_numpy(x), k), jresize.area_down(jnp.asarray(x), k))
    _close(tresize.area_up(torch.from_numpy(x), k), jresize.area_up(jnp.asarray(x), k),
           atol=0)


@pytest.mark.parametrize("hw", [(40, 52), (32, 32), (9, 20)])
def test_adaptive_avg_pool2d(hw):
    # (9, 20): an input smaller than the 32x32 output
    x = _rand(4, (1, 2) + hw + (4,))
    _close(tresize.adaptive_avg_pool2d(torch.from_numpy(x), (32, 32)),
           jresize.adaptive_avg_pool2d(jnp.asarray(x), (32, 32)))


def test_quantize_ste_forward():
    x = _rand(5, (2, 3, 4, 5, 3), 0.7) + 0.5
    # keep clear of the rounding boundaries: x*255 in fp32 may land on
    # either side of a half-integer in the two frameworks
    frac = np.abs((np.clip(x, 0, 1) * 255) % 1 - 0.5)
    x = np.where(frac < 1e-3, x + 2e-3, x).astype(np.float32)
    _close(tquant.quantize_ste(torch.from_numpy(x)),
           jquant.quantize_ste(jnp.asarray(x)), atol=1e-7)


def test_quantize_ste_identity_gradient():
    x = torch.from_numpy(_rand(6, (2, 5), 1.0)).requires_grad_(True)
    w = torch.from_numpy(_rand(7, (2, 5)))
    (tquant.quantize_ste(x) * w).sum().backward()
    _close(x.grad, w.numpy(), atol=0)
    g = jax.grad(lambda v: jnp.sum(jquant.quantize_ste(v) * w.numpy()))(
        jnp.asarray(x.detach().numpy()))
    _close(x.grad, g, atol=0)


@pytest.mark.parametrize("half_logvar", [False, True])
def test_gmm_sample_shared_eps(half_logvar, monkeypatch):
    hf, K = 12, 5
    raw = _rand(8, (1, 2, 3, 4, hf * K * 3), 2.0)
    eps = _rand(9, (1, 2, 3, 4, hf, K))
    monkeypatch.setattr(jgmm, "sample_normal", lambda rng, shape, dtype: jnp.asarray(eps))
    want = jgmm.gmm_sample(jgmm.split_params(jnp.asarray(raw), hf, K), None,
                           half_logvar=half_logvar)
    got = tgmm.gmm_sample(tgmm.split_params(torch.from_numpy(raw), hf, K),
                          torch.from_numpy(eps), half_logvar=half_logvar)
    # exp(clip(., 7)) reaches ~1e3, so compare relative to that scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gmm_neg_log_likelihood():
    hf, K = 12, 5
    raw = _rand(10, (1, 2, 3, 4, hf * K * 3))
    x = _rand(11, (1, 2, 3, 4, hf))
    want = jgmm.gmm_neg_log_likelihood(jgmm.split_params(jnp.asarray(raw), hf, K),
                                       jnp.asarray(x))
    got = tgmm.gmm_neg_log_likelihood(
        tgmm.split_params(torch.from_numpy(raw), hf, K), torch.from_numpy(x))
    _close(got, want, atol=1e-5)  # a mean over 288 logsumexps of O(1..10) values


@pytest.mark.parametrize("T", [1, 2, 5])
def test_temporal_conv3(T):
    x, w, b = _rand(12, (2, T, 3, 4, 6)), _rand(13, (3, 6, 5), 0.3), _rand(14, (5,))
    _close(tconv.temporal_conv3(*map(torch.from_numpy, (x, w, b))),
           jconv.temporal_conv3(*map(jnp.asarray, (x, w, b))))


@pytest.mark.parametrize("bias", [True, False])
def test_spatial_conv_video(bias):
    x, w = _rand(15, (1, 2, 5, 7, 6)), _rand(16, (3, 3, 6, 4), 0.2)
    b = _rand(17, (4,)) if bias else None
    _close(tconv.spatial_conv_video(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b) if bias else None),
           jconv.spatial_conv_video(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b) if bias else None))


def test_pointwise_and_leaky_relu():
    x, w, b = _rand(18, (2, 3, 4, 6)), _rand(19, (6, 5), 0.3), _rand(20, (5,))
    _close(tconv.pointwise(*map(torch.from_numpy, (x, w, b))),
           jconv.pointwise(*map(jnp.asarray, (x, w, b))))
    _close(tconv.leaky_relu(torch.from_numpy(x)), jconv.leaky_relu(jnp.asarray(x)), atol=0)


@pytest.mark.parametrize("shape", [(3, 3, 8, 32), (3, 16, 4), (64, 64)])
def test_initialisers_scale_and_determinism(shape):
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    fan_in, fan_out = tconv._fans(shape)
    assert (fan_in, fan_out) == jconv._fans(shape)
    w = tconv.xavier_normal(0.1)(shape, g())
    assert torch.equal(w, tconv.xavier_normal(0.1)(shape, g()))
    big = tconv.xavier_normal(1.0)((3, 3, 64, 256), g())
    assert abs(big.std().item() / (2.0 / (9 * 320)) ** 0.5 - 1) < 0.02
    u = tconv.torch_default_w(shape, g())
    assert u.abs().max().item() <= fan_in ** -0.5
    assert tconv.torch_default_b(fan_in)((7,), g()).abs().max().item() <= fan_in ** -0.5
    assert tconv.zeros_init(shape).abs().sum().item() == 0
