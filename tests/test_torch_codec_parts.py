"""The codec training slice's parts against the JAX package, fp32 on the CPU:
the surrogate's blocks (``DenseBlock2D``, ``FeatureCollapse``), the surrogate
nets, the chain routes, the mimick losses and the value swap, the host codec
span, the q stream and the codec noise (the training step itself is in
test_torch_codec_train.py).

On the JAX side parameter shapes come from ``jax.eval_shape``, never a flax
``init``. Tolerances: modules 1e-5 abs (the same fp32 products summed in
another order, activations of order one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.codec import surrogate as jsur
from selfc_tpu.models import blocks as jblocks
from selfc_tpu.train.codec_model import CodecModel as JCodecModel
from selfc_tpu_torch.codec import surrogate as tsur
from selfc_tpu_torch.codec.noise import add_noise
from selfc_tpu_torch.models import blocks as tblocks
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.utils.jax_import import load_jax_params
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


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


def _both(jm, tm, seed, x, *args):
    """(jax output, port output) of one module with the same seeded
    parameters on the same input."""
    tree = seeded_tree(jm, seed, jnp.asarray(x), *args)
    load_jax_params(tm, tree)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, *args))(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *args).numpy()
    return want, got


@pytest.mark.parametrize("c_in,c_out,is_res,shape", [
    (4, 6, False, (2, 8, 12)),          # images (N,H,W,C): the reference DenseBlock
    (6, 6, True, (1, 2, 8, 12)),        # every frame of a video, residual
])
def test_dense_block_2d_matches_jax(c_in, c_out, is_res, shape):
    x = _rand(1, shape + (c_in,))
    want, got = _both(jblocks.DenseBlock2D(c_in, c_out, init_mode="plain_xavier", is_res=is_res),
                      tblocks.DenseBlock2D(c_in, c_out, init_mode="plain_xavier", is_res=is_res), 2, x)
    assert got.shape == want.shape == shape + (c_out,)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("scale,is_res", [(4, True), (2, False)])
def test_feature_collapse_matches_jax(scale, is_res):
    """Space-to-depth (block-position-major), a chain with full 3x3x3 convs
    first and last, depth-to-space (PixelShuffle order)."""
    x = _rand(3, (1, 3, 8, 8, 3))
    want, got = _both(jblocks.FeatureCollapse(3, 3, scale, 4, is_res=is_res),
                      tblocks.FeatureCollapse(3, 3, scale, 4, is_res=is_res), 4, x)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dynamic_q", [False, True])
def test_h265_surrogate_matches_jax(dynamic_q):
    """The published surrogate (hidden 24, two FeatureCollapse blocks), with
    the t indicator plane or the (t, q/30) token MLP."""
    lr = np.random.default_rng(5).random((1, 3, 8, 8, 3), dtype=np.float32)
    q = jnp.float32(21.0)
    jm, tm = jsur.H265Surrogate(dynamic_q=dynamic_q), tsur.H265Surrogate(dynamic_q)
    tree = seeded_tree(jm, 6, jnp.asarray(lr), q)
    load_jax_params(tm, tree)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, q))(tree, jnp.asarray(lr)))
    with torch.no_grad():
        got = tm(torch.from_numpy(lr), 21.0).numpy()
    assert ("fuser_0" in tree) == dynamic_q
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_h265_surrogate_plain_matches_jax():
    lr = np.random.default_rng(7).random((1, 3, 8, 8, 3), dtype=np.float32)
    want, got = _both(jsur.H265SurrogatePlain(), tsur.H265SurrogatePlain(), 8, lr)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dense_chain_routes():
    """D2DT takes the whole-chain kernel's route, a growth-32 chain of
    spatial convs with another conv5 the v1 spatial chain's, FeatureCollapse's
    chain (growth 128, 3-D convs) the plain convs."""
    calls = []
    routes = {"dense_chain_t_ep": dc.dense_chain_t_ep, "fused_dense_spatial": dc.fused_dense_spatial}
    try:
        for name, fn in routes.items():
            setattr(dc, name, lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
        x = torch.from_numpy(_rand(9, (1, 3, 8, 8, 4)))
        tblocks.D2DT(4, 4)(x)
        tblocks.DenseBlock2D(4, 4)(x)
        tblocks.DenseBlock2D(4, 4, gc=12)(x)
        tblocks.FeatureCollapse(4, 4, 4)(x)
    finally:
        for name, fn in routes.items():
            setattr(dc, name, fn)
    assert calls == ["dense_chain_t_ep", "fused_dense_spatial"]


def test_mimick_and_swap_value_is_codec_grad_is_surrogate():
    """As tests/test_codec.py's TestSurrogateSwap, and against the JAX
    function: the loss (MSE - lambda * Pearson), the swapped value, and the
    gradient reaching the surrogate's output."""
    sug_np, codec_np = _rand(10, (2, 3, 4, 4, 3)), _rand(11, (2, 3, 4, 4, 3))

    def jf(s):
        swapped, loss = jsur.mimick_and_swap(s, jnp.asarray(codec_np), 1e-2)
        return jnp.sum(swapped ** 2) + loss, (swapped, loss)

    (_, (j_sw, j_loss)), j_grad = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(sug_np))
    sug = torch.from_numpy(sug_np).requires_grad_(True)
    swapped, loss = tsur.mimick_and_swap(sug, torch.from_numpy(codec_np), 1e-2)
    (torch.sum(swapped ** 2) + loss).backward()
    np.testing.assert_allclose(swapped.detach().numpy(), codec_np, atol=1e-6)  # sug + (codec - sug)
    np.testing.assert_array_equal(swapped.detach().numpy(), np.asarray(j_sw))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(sug.grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-7)
    assert np.abs(sug.grad.numpy()).max() > 0


def test_mimick_plain_matches_jax():
    sug_np, codec_np = _rand(12, (1, 3, 4, 4, 3)), _rand(13, (1, 3, 4, 4, 3))
    j_out, j_loss = jsur.mimick_plain(jnp.asarray(sug_np), jnp.asarray(codec_np))
    sug = torch.from_numpy(sug_np).requires_grad_(True)
    out, loss = tsur.mimick_plain(sug, torch.from_numpy(codec_np))
    loss.backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(sug.grad.numpy(), 2 * (sug_np - codec_np) / sug_np.size, rtol=1e-5)


@pytest.mark.parametrize("stand_in", ["zlib", "null"])
def test_h265_host_roundtrip_matches_jax(monkeypatch, stand_in):
    """The stand-in on both stacks (no real x265): the same decoded clips,
    bit for bit, and the same mean bpp."""
    monkeypatch.setenv("SELFC_TPU_DISABLE_X265", "1")
    lr = np.random.default_rng(14).random((3, 3, 16, 24, 3), dtype=np.float32) * 1.2 - 0.1
    want, want_bpp = jsur.h265_host_roundtrip(lr, 16, 3, 2, stand_in=stand_in)
    got, got_bpp = tsur.h265_host_roundtrip(lr, 16, 3, 2, stand_in=stand_in)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got_bpp == want_bpp


def test_draw_q_matches_jax():
    j, t = object.__new__(JCodecModel), object.__new__(CodecModel)
    for m in (j, t):
        m._q_seed, m.q = 3, [8, 35]
    assert [t._draw_q(s) for s in range(40)] == [j._draw_q(s) for s in range(40)]


def test_add_noise_draws_from_its_generator():
    x = torch.zeros(20000)
    u = add_noise(x, torch.Generator().manual_seed(0), 1e-3, "uniform")
    assert torch.equal(u, add_noise(x, torch.Generator().manual_seed(0), 1e-3, "uniform"))
    assert 1e-4 <= u.abs().min().item() and u.abs().max().item() <= 1e-3
    assert abs((u > 0).float().mean().item() - 0.5) < 0.02
    g = add_noise(x, torch.Generator().manual_seed(1), 1e-3, "gaussian")
    assert abs(g.std().item() - 2e-3) < 1e-4
    with pytest.raises(ValueError):
        add_noise(x, torch.Generator(), 1e-3, "laplace")
