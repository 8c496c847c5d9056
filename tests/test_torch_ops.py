"""The port's plain frequency split, shuffles and resizes
(selfc_tpu_torch.ops) against the JAX package's, on the same numpy inputs,
fp32, on the CPU (quantisation, GMM, convolutions and initialisers:
test_torch_ops_conv_gmm.py). atol 1e-6: these are reorderings,
means over at most a few hundred values and single small products, so only
the last bit of a sum's order can differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.ops import freq as jfreq
from selfc_tpu.ops import resize as jresize
from selfc_tpu.ops import shuffle as jshuffle
from selfc_tpu_torch.ops import freq as tfreq
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
def test_freq_forward_bf16_rounds_once_as_jax(k):
    """In bf16 the JAX package's one strided conv sums in fp32 and rounds
    once; so does the port. Where the two fp32 sums straddle a bf16
    rounding boundary the results are one bf16 step apart; a second
    rounding (the high frequencies from a bf16-rounded mean) puts many more
    elements off."""
    x = np.random.default_rng(3).random((1, 3, 32, 48, 3), dtype=np.float32)
    got = tfreq.freq_forward(torch.from_numpy(x).to(torch.bfloat16), k).float().numpy()
    want = np.asarray(jfreq.freq_forward(jnp.asarray(x, jnp.bfloat16), k).astype(jnp.float32))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step)
    assert np.mean(got != want) < 1e-3


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


