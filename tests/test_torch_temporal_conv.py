"""The standalone (3,1,1) temporal conv of the port
(``selfc_tpu_torch/ops/temporal_conv.py:temporal_conv3_fused``, kernel B6)
against the JAX package's ``temporal_conv3_pallas`` (its Pallas kernel,
interpreted on the CPU) and ``temporal_conv3``: the cases of
tests/test_pallas.py, and the dilations the block families use.

On the CPU the port runs the plain version of the kernel; the CUDA source
itself is held on the CPU by tests/test_torch_cuda_sources_on_cpu.py.

Tolerances: atol and rtol 1e-5 for a forward (the same fp32 products,
summed in another order), 1e-4 for a gradient (as tests/test_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.ops.conv import leaky_relu as jleaky_relu
from selfc_tpu.ops.conv import temporal_conv3 as jtemporal_conv3
from selfc_tpu.ops.pallas_kernels import temporal_conv3_pallas
from selfc_tpu_torch.ops import temporal_conv as tc
from selfc_tpu_torch.ops.conv import temporal_conv3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, x_shape, c_out, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.random(x_shape).astype(np.float32)
    w = (rng.standard_normal((3, x_shape[-1], c_out)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(c_out) * 0.1).astype(np.float32) if bias else None
    return x, w, b


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def test_matches_pallas():
    x, w, b = _inputs(0, (2, 5, 8, 16, 20), 12)
    want = temporal_conv3_pallas(*_jax(x, w, b))
    got = tc.temporal_conv3_fused(*_torch(x, w, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("slope", [0.2, 0.0])
def test_fused_lrelu_matches_pallas(slope):
    x, w, b = _inputs(1, (1, 3, 8, 8, 7), 5)
    want = temporal_conv3_pallas(*_jax(x, w, b), negative_slope=slope)
    got = tc.temporal_conv3_fused(*_torch(x, w, b), negative_slope=slope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jleaky_relu(jtemporal_conv3(*_jax(x, w, b)), slope)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("slope", [0.2, 0.0, None])
def test_grads_match_pallas(slope):
    """dx (the conv again, with the flipped weights), dw and db against the
    custom VJP of the Pallas kernel. At slope 0 the mask is the one the
    forward saved; at 0.2 it is read off the output."""
    x, w, b = _inputs(3, (1, 3, 8, 16, 20), 12)

    def loss(x, w, b):
        return jnp.sum(temporal_conv3_pallas(x, w, b, negative_slope=slope) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*_jax(x, w, b))
    leaves = [t.requires_grad_(True) for t in _torch(x, w, b)]
    (tc.temporal_conv3_fused(*leaves, negative_slope=slope) ** 2).sum().backward()
    for t, wnt in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt), rtol=1e-4, atol=1e-4)


def test_ragged_shape():
    """H*W = 35 (the JAX wrapper falls back to XLA there); the port's kernel
    and its plain version take every shape. No bias."""
    x, w, _ = _inputs(2, (1, 3, 5, 7, 4), 4)
    want = temporal_conv3_pallas(*_jax(x, w), None, tile_s=16)
    got = tc.temporal_conv3_fused(*_torch(x, w), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [1, 2, 3])
def test_short_clips_match_pallas(T):
    """T = 1: both neighbour taps lie in the padding; T = 2, 3: one of them
    at each end."""
    x, w, b = _inputs(5, (2, T, 4, 6, 9), 3)
    want = temporal_conv3_pallas(*_jax(x, w, b))
    got = tc.temporal_conv3_fused(*_torch(x, w, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_dilated_temporal_conv_matches_jax(dilation):
    """D2DTEnhance's conv51..53: the plain conv at dilations 1, 2 and 3
    (T = 5: at 3 a tap lies in the padding at every frame but the middle
    ones), forward and gradient."""
    x, w, b = _inputs(4, (2, 5, 4, 6, 9), 7)
    want = jtemporal_conv3(*_jax(x, w, b), dilation=dilation)
    xt, wt, bt = [t.requires_grad_(True) for t in _torch(x, w, b)]
    got = temporal_conv3(xt, wt, bt, dilation=dilation)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jg = jax.grad(lambda *a: jnp.sum(jtemporal_conv3(*a, dilation=dilation) ** 2),
                  argnums=(0, 1, 2))(*_jax(x, w, b))
    (got ** 2).sum().backward()
    for t, wnt in zip((xt, wt, bt), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wnt), rtol=1e-4, atol=1e-4)


def test_bf16_rounds_the_fp32_result_once():
    """bf16 input: the products and the LeakyReLU in fp32 and one rounding
    at the end, as the kernel does."""
    x, w, b = _inputs(6, (1, 3, 4, 5, 16), 8)
    xb, wb, bb = [t.bfloat16() for t in _torch(x, w, b)]
    got = tc.temporal_conv3_fused(xb, wb, bb, 0.2)
    want = tc.temporal_conv3_fused(xb.float(), wb.float(), bb.float(), 0.2).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    tc.reset_launch_counts()
    x, w, b = _inputs(7, (1, 3, 4, 4, 5), 6)
    leaves = [t.requires_grad_(True) for t in _torch(x, w, b)]
    tc.temporal_conv3_fused(*leaves, negative_slope=0.2).sum().backward()
    assert (tc.launches, tc.launches_bwd) == (0, 0)
    assert tc.launches_by_width == {} and tc.launches_bwd_by_width == {} and tc.launches_by_path == {}


def test_plan_picks_the_tile_from_co_and_splits_k_only_on_a_short_grid():
    """The kernel's tile path and K split (csrc/temporal_conv.cu) for an
    H100's 132 SMs at the nets' latents: the narrow tile to Co = 16, K split
    while the tiles fill fewer SMs than the card has, in at most 8 parts of
    two 16-channel slabs or more."""
    fp32 = 4
    assert tc.plan(1, 7, 144 * 176, 176, 3, fp32, 132) == ("narrow", 1)
    assert tc.plan(1, 7, 144 * 176, 131, 48, fp32, 132) == ("wide", 1)
    assert tc.plan(1, 7, 36 * 44, 1152, 48, fp32, 132) == ("wide", 2)   # 88 tiles
    assert tc.plan(8, 7, 9 * 9, 1152, 48, fp32, 132) == ("wide", 4)     # 40 tiles
    assert tc.plan(8, 7, 9 * 9, 432, 768, fp32, 132) == ("wide", 1)     # 40 x 16 column tiles
    assert tc.plan(8, 7, 9 * 9, 1152, 48, fp32, 1) == ("wide", 1)
    assert tc.plan(1, 1, 1, 1152, 48, fp32, 10**6) == ("wide", 8)
    assert tc.plan(1, 1, 1, 40, 3, fp32, 10**6) == ("narrow", 1)        # 3 slabs
    assert tc.plan(1, 1, 1, 64, 16, fp32, 10**6) == ("narrow", 2)       # 4 slabs
    assert tc.plan(1, 1, 1, 64, 16, 2, 10**6) == ("narrow", 1)          # 2 bf16 slabs of 32


def test_flipped_weights_give_the_data_gradient():
    """dx = temporal_conv3(dy, [w2^T, w1^T, w0^T]): the identity the
    backward's kernel launch rests on, against autograd of the plain conv."""
    x, w, _ = _inputs(8, (2, 4, 3, 5, 6), 4)
    xt, wt = _torch(x, w)
    xt.requires_grad_(True)
    dy = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 4, 3, 5, 4)).astype(np.float32))
    (dx,) = torch.autograd.grad(temporal_conv3(xt, wt), xt, dy)
    got = tc.temporal_conv3_fused_plain(dy, tc._flipped(wt))
    np.testing.assert_allclose(got.numpy(), dx.numpy(), rtol=1e-5, atol=1e-5)
