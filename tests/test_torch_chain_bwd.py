"""The gradient of the port's dense chain (selfc_tpu_torch.ops.dense_chain)
against the JAX package: ``jax.vjp`` of the XLA formulation and the Pallas
adjoint / spatial-only forward in interpret mode, on the same numpy inputs,
fp32, on the CPU.

On the CPU the port runs its plain PyTorch versions (the explicit backward
sweep, not autograd); the CUDA kernels are compared with those plain
versions on the GPU by ``chip_smoke.py``.

Tolerances are those of tests/test_pallas_chain.py for the same
comparisons: features atol 2e-5; dx rtol 1e-5 / atol 1e-4; dW and db, which
sum over every pixel, rtol 1e-5 / atol 1e-3; gradients through conv5 and an
epilogue rtol 1e-5 / atol 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.ops.pallas_chain import (
    _pallas_bwd, _pallas_feats, _xla_impl, _xla_impl_v2, _xla_impl_v2_ep, fused_dense_spatial)
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.utils.bench import chain_bwd_cost, chain_feats_cost


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

MODES = tuple(dc.EP_AUX)
# (shape, C): W not a multiple of 16, B*T > 1, H != W, widths 3 and 48/64
SPATIAL_CASES = [((2, 1, 12, 20), 3), ((1, 2, 12, 10), 48), ((2, 2, 6, 9), 64)]


def _chain(seed, C, c_out, shape, std=1.0):
    rng = np.random.default_rng(seed)
    f = lambda s, sc: rng.normal(0, sc, s).astype(np.float32)  # noqa: E731
    ws = [f((3, 3, C + 32 * k, 32), std * (9 * (C + 32 * k)) ** -0.5) for k in range(4)]
    bs = [f((32,), 0.1) for _ in range(4)]
    w5, b5 = f((3, C + 128, c_out), (3 * (C + 128)) ** -0.5), f((c_out,), 0.1)
    x = f(shape + (C,), 1.0)
    a, m = f(shape + (c_out,), 1.0), f(shape + (c_out,), 1.0)
    g = f(shape + (128,), 1.0)
    return x, ws, bs, w5, b5, a, m, g


def _t(v):
    return [torch.from_numpy(u) for u in v] if isinstance(v, list) else torch.from_numpy(v)


def _j(v):
    return tuple(jnp.asarray(u) for u in v) if isinstance(v, list) else jnp.asarray(v)


def _jax_vjp(fn, args, g):
    """``jax.vjp(fn, *args)[1](g)`` as one jitted program: run eagerly, each
    op of the chain compiles on its own, which takes several times as long."""
    return jax.jit(lambda args, g: jax.vjp(fn, *args)[1](g))(args, g)


def _assert_bwd(got, want):
    """(dx, dws, dbs) from the port against the JAX side's."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-4)
    for u, v in zip([*got[1], *got[2]], jax.tree.leaves((want[1], want[2]))):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape,C", SPATIAL_CASES)
def test_feats_plain_matches_xla_and_pallas(shape, C):
    x, ws, bs, *_ = _chain(1, C, 3, shape)
    got = dc.chain_feats(_t(x), _t(ws), _t(bs)).numpy()  # a CPU tensor: the plain version
    assert got.shape == shape + (128,)
    np.testing.assert_allclose(got, np.asarray(jax.jit(_xla_impl)(_j(x), _j(ws), _j(bs))), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(_pallas_feats(_j(x), _j(ws), _j(bs))), atol=2e-5)


@pytest.mark.parametrize("shape,C", SPATIAL_CASES)
def test_spatial_bwd_plain_matches_jax_vjp(shape, C):
    x, ws, bs, _, _, _, _, g = _chain(2, C, 3, shape)
    feats = dc.chain_feats_plain(_t(x), _t(ws), _t(bs))
    got = dc.chain_spatial_bwd(_t(x), _t(ws), _t(bs), feats, _t(g))
    _assert_bwd(got, _jax_vjp(_xla_impl, (_j(x), _j(ws), _j(bs)), _j(g)))


# smaller images for C = 48 and 64 keep the Pallas interpreter's run short
# (H must be a multiple of 4 for its row tiles)
PALLAS_BWD_CASES = [SPATIAL_CASES[0], ((1, 2, 4, 10), 48), ((2, 1, 4, 9), 64)]


@pytest.mark.parametrize("saved", [False, True])
@pytest.mark.parametrize("shape,C", PALLAS_BWD_CASES)
def test_spatial_bwd_plain_matches_pallas_bwd(shape, C, saved):
    x, ws, bs, _, _, _, _, g = _chain(3, C, 3, shape)
    feats = dc.chain_feats_plain(_t(x), _t(ws), _t(bs))
    got = dc.chain_spatial_bwd_plain(_t(x), _t(ws), _t(bs), feats, _t(g))
    jfeats = _pallas_feats(_j(x), _j(ws), _j(bs), keep_pad=True) if saved else None
    _assert_bwd(got, _pallas_bwd(_j(x), _j(ws), _j(bs), _j(g), feats=jfeats))


@pytest.mark.parametrize("shape,C", SPATIAL_CASES)
def test_spatial_bwd_plain_matches_torch_autograd(shape, C):
    """The explicit sweep against autograd of the plain forward, with a
    gradient that reaches x directly as well (``dx0``)."""
    x, ws, bs, _, _, _, _, g = _chain(4, C, 3, shape)
    dx0 = np.random.default_rng(5).normal(0, 1, x.shape).astype(np.float32)
    leaves = [_t(x), *_t(ws), *_t(bs)]
    for t in leaves:
        t.requires_grad_(True)
    feats = dc.chain_feats_plain(leaves[0], leaves[1:5], leaves[5:])
    want = torch.autograd.grad([feats, leaves[0]], leaves, [_t(g), _t(dx0)])
    with torch.no_grad():
        got = dc.chain_spatial_bwd_plain(leaves[0], leaves[1:5], leaves[5:], feats, _t(g), _t(dx0))
    for u, v in zip([got[0], *got[1], *got[2]], want):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-5, atol=1e-4)


def test_spatial_bwd_zero_output_takes_the_slope_branch():
    """A saved output of exactly 0 takes the 0.2 slope, as on the JAX side
    (mask from ``x_k > 0``)."""
    x, ws, bs, _, _, _, _, g = _chain(6, 3, 3, (1, 1, 5, 6))
    feats = dc.chain_feats_plain(_t(x), _t(ws), _t(bs))
    feats[..., 96:] = 0.0  # the last layer's output: nothing reads it in the sweep
    dx, dws, dbs = dc.chain_spatial_bwd_plain(_t(x), _t(ws), _t(bs), feats, _t(g))
    # 30 fp32 terms summed in two orders
    np.testing.assert_allclose(dbs[3].numpy(), 0.2 * g[..., 96:].sum((0, 1, 2, 3)), rtol=1e-4, atol=1e-5)


def test_spatial_bwd_bf16_contract():
    """bf16 inputs: the explicit sweep keeps its running gradient in fp32,
    so against the fp32 truth it is no less accurate than autograd through
    the bf16 chain (the inequality of test_pallas_bwd_bf16)."""
    x, ws, bs, _, _, _, _, g = _chain(7, 32, 3, (1, 1, 12, 16))
    leaves = [_t(x), *_t(ws), *_t(bs)]
    with torch.no_grad():
        truth = dc.chain_spatial_bwd_plain(
            leaves[0], leaves[1:5], leaves[5:], dc.chain_feats_plain(leaves[0], leaves[1:5], leaves[5:]), _t(g))
    hb = [t.bfloat16().requires_grad_(True) for t in leaves]
    gb = _t(g).bfloat16()
    feats = dc.chain_feats_plain(hb[0], hb[1:5], hb[5:])
    ref = torch.autograd.grad(feats, hb, gb)
    with torch.no_grad():
        got = dc.chain_spatial_bwd_plain(hb[0], hb[1:5], hb[5:], feats, gb)
    assert got[0].dtype == torch.bfloat16 and got[1][0].dtype == torch.bfloat16
    for u, v, t in zip([got[0], *got[1], *got[2]], ref, [truth[0], *truth[1], *truth[2]]):
        ea = (u.float() - t).abs().max().item()
        eb = (v.float() - t).abs().max().item()
        assert ea <= 2.0 * eb + 1e-3, (ea, eb)


def _port_grads(x, ws, bs, w5, b5, a, m, mode, clamp, gout, save_feats):
    n_aux = dc.EP_AUX[mode]
    leaves = [_t(x), *_t(ws), *_t(bs), _t(w5), _t(b5), *[_t(v) for v in (a, m)[:n_aux]]]
    for t in leaves:
        t.requires_grad_(True)
    aux = leaves[11:] + [None, None]
    y = dc.dense_chain_t_ep(leaves[0], leaves[1:5], leaves[5:9], leaves[9], leaves[10],
                            mode, clamp, aux[0], aux[1], save_feats=save_feats)
    return [t.numpy() for t in torch.autograd.grad(y, leaves, _t(gout))]


@pytest.mark.parametrize("save_feats", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_chain_ep_grads_match_jax_oracle(mode, save_feats):
    """``dense_chain_t_ep`` under torch autograd against ``jax.vjp`` of
    ``_xla_impl_v2_ep``: gradients of x, the ten parameters, a and m. Two
    clips in the batch: a conv5 tap must not cross from one into the next."""
    shape, C, c_out, clamp = (2, 3, 6, 10), 3, 48, 0.8
    x, ws, bs, w5, b5, a, m, _ = _chain(8, C, c_out, shape)
    gout = np.random.default_rng(9).normal(0, 1, shape + (c_out,)).astype(np.float32)
    got = _port_grads(x, ws, bs, w5, b5, a, m, mode, clamp, gout, save_feats)
    aux = [_j(v) for v in (a, m)[:dc.EP_AUX[mode]]]
    want = jax.tree.leaves(_jax_vjp(lambda *args: _xla_impl_v2_ep(mode, clamp, *args),
                                    (_j(x), _j(ws), _j(bs), _j(w5), _j(b5), *aux), _j(gout)))
    assert len(got) == len(want)
    for u, v in zip(got, want):
        np.testing.assert_allclose(u, np.asarray(v), rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("C,c_out", [(48, 3), (64, 64)])
def test_chain_ep_grads_other_widths(C, c_out):
    shape = (1, 2, 5, 7)
    x, ws, bs, w5, b5, a, m, _ = _chain(10, C, c_out, shape)
    gout = np.random.default_rng(11).normal(0, 1, shape + (c_out,)).astype(np.float32)
    got = _port_grads(x, ws, bs, w5, b5, a, m, "sub_mul", 1.0, gout, True)
    want = _jax_vjp(lambda *args: _xla_impl_v2_ep("sub_mul", 1.0, *args),
                    (_j(x), _j(ws), _j(bs), _j(w5), _j(b5), _j(a), _j(m)), _j(gout))
    for u, v in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(u, np.asarray(v), rtol=1e-5, atol=2e-3)


def test_saved_feats_equal_recomputed_feats():
    shape = (1, 3, 12, 10)
    x, ws, bs, w5, b5, a, m, _ = _chain(12, 3, 48, shape)
    gout = np.random.default_rng(13).normal(0, 1, shape + (48,)).astype(np.float32)
    saved = _port_grads(x, ws, bs, w5, b5, a, m, "mul_add", 1.0, gout, True)
    again = _port_grads(x, ws, bs, w5, b5, a, m, "mul_add", 1.0, gout, False)
    for u, v in zip(saved, again):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("mode", MODES)
def test_chain_ep_gradcheck_float64(mode):
    """The hand-written backward against finite differences, in float64 on
    a 1x2x4x5 input through the plain path. Growth width 4 (the plain
    versions take any) keeps the number of perturbed parameters small."""
    n_aux = dc.EP_AUX[mode]
    rng = np.random.default_rng(14)
    C, gc, c_out, shape = 2, 4, 3, (1, 2, 4, 5)
    f = lambda *s: torch.from_numpy(rng.normal(0, 0.5, s)).requires_grad_(True)  # noqa: E731
    ws = [f(3, 3, C + gc * k, gc) for k in range(4)]
    bs = [f(gc) for _ in range(4)]
    x, w5, b5, a = f(*shape, C), f(3, C + 4 * gc, c_out), f(c_out), f(*shape, c_out)
    m = (f(*shape, c_out).detach().abs() + 0.5).requires_grad_(True)

    def fn(x, w5, b5, a, m, *wbs):
        return dc.dense_chain_t_ep(x, wbs[:4], wbs[4:], w5, b5, mode, 0.8,
                                   a if n_aux >= 1 else None, m if n_aux >= 2 else None)

    assert torch.autograd.gradcheck(fn, (x, w5, b5, a, m, *ws, *bs), eps=1e-6, atol=1e-5,
                                    rtol=1e-4, check_undefined_grad=False)


def test_grads_reach_fp32_masters_through_the_cast():
    """bf16 activations, fp32 parameters: the cast sits outside the autograd
    function, so the parameters receive fp32 gradients of their own shape."""
    x, ws, bs, w5, b5, a, m, _ = _chain(15, 3, 48, (1, 2, 4, 6))
    params = [*_t(ws), *_t(bs), _t(w5), _t(b5)]
    for p in params:
        p.requires_grad_(True)
    y = dc.dense_chain_t_ep(_t(x).bfloat16(), params[:4], params[4:8], params[8], params[9],
                            "mul_add", 1.0, _t(a).bfloat16(), _t(m).bfloat16())
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    for p in params:
        assert p.grad is not None and p.grad.dtype == torch.float32 and p.grad.shape == p.shape
        assert torch.isfinite(p.grad).all()


def test_backward_skips_what_is_not_asked():
    x, ws, bs, w5, b5, a, m, _ = _chain(16, 3, 48, (1, 1, 4, 4))
    tw5 = _t(w5).requires_grad_(True)
    y = dc.dense_chain_t_ep(_t(x), _t(ws), _t(bs), tw5, _t(b5), "mul_add", 1.0, _t(a), _t(m))
    (g,) = torch.autograd.grad(y.sum(), [tw5])
    assert g.shape == tw5.shape


def test_cpu_backward_launches_nothing():
    dc.reset_launch_counts()
    x, ws, bs, w5, b5, a, m, _ = _chain(17, 3, 48, (1, 1, 4, 4))
    gout = np.ones((1, 1, 4, 4, 48), np.float32)
    _port_grads(x, ws, bs, w5, b5, a, m, "add", 1.0, gout, False)
    assert (dc.launches, dc.launches_bwd, dc.launches_feats) == (0, 0, 0)


@pytest.mark.parametrize("fault,error", [
    ("feats_shape", ValueError), ("dfeats_dtype", ValueError), ("dx_strided", ValueError),
    ("gc_16", ValueError), ("x_dtype", TypeError),
])
def test_backward_kernel_argument_checks_reject(fault, error, monkeypatch):
    """What the adjoint's CUDA path refuses, checked before any launch."""
    monkeypatch.setattr(dc, "_library", lambda name: pytest.fail("a refused call reached the library"))
    x, ws, bs, *_ = _chain(18, 8, 3, (1, 2, 4, 5))
    x, ws, bs = _t(x), _t(ws), _t(bs)
    feats = torch.zeros(1, 2, 4, 5, 128)
    dfeats, dx = torch.zeros(1, 2, 4, 5, 128), torch.zeros(1, 2, 4, 5, 8)
    if fault == "feats_shape":
        feats = feats[..., :96].contiguous()
    elif fault == "dfeats_dtype":
        dfeats = dfeats.bfloat16()
    elif fault == "dx_strided":
        dx = torch.zeros(1, 2, 4, 5, 16)[..., :8]
    elif fault == "gc_16":
        ws = [w[..., :16].contiguous() for w in ws]
    elif fault == "x_dtype":
        x = x.double()
    with pytest.raises(error):
        dc._bwd_cuda(x, ws, bs, feats, dfeats, dx)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 5, 4), (8, 7, 36, 36)])
@pytest.mark.parametrize("C", [3, 48, 64])
def test_backward_cost_model_counts_only_taps_inside_the_image(C, shape):
    """``chain_bwd_cost`` / ``chain_feats_cost`` against a count made by
    convolving ones: the data gradient and the weight gradient each repeat
    the forward's products."""
    B, T, H, W = shape
    ones = torch.ones(1, 1, H, W, dtype=torch.float64)
    taps = torch.nn.functional.conv2d(ones, torch.ones(1, 1, 3, 3, dtype=torch.float64), padding=1).sum().item()
    macs = B * T * taps * sum((C + 32 * k) * 32 for k in range(4))
    n_params = sum(9 * (C + 32 * k) * 32 + 32 for k in range(4))
    px = B * T * H * W
    ops, nbytes = chain_feats_cost(B, T, H, W, C, 4)
    assert ops == pytest.approx(2 * macs, rel=1e-12)
    assert nbytes == 4 * (px * (C + 128) + n_params)
    ops, nbytes = chain_bwd_cost(B, T, H, W, C, 2)
    assert ops == pytest.approx(4 * macs, rel=1e-12)
    assert nbytes == 2 * (px * (C + 128) + 2 * n_params) + 4 * px * (128 + 2 * C)


# ---------------------------------------------------------------------------
# growth width below 32 (the codec prior's 12), and the feats layouts
# ---------------------------------------------------------------------------


def _chain_gc(seed, C, gc, c_out, shape):
    rng = np.random.default_rng(seed)
    f = lambda s, sc: rng.normal(0, sc, s).astype(np.float32)  # noqa: E731
    ws = [f((3, 3, C + gc * k, gc), (9 * (C + gc * k)) ** -0.5) for k in range(4)]
    bs = [f((gc,), 0.1) for _ in range(4)]
    w5, b5 = f((3, C + 4 * gc, c_out), (3 * (C + 4 * gc)) ** -0.5), f((c_out,), 0.1)
    return f(shape + (C,), 1.0), ws, bs, w5, b5


@pytest.mark.parametrize("save_feats", [True, False])
@pytest.mark.parametrize("gc,C,c_out", [(12, 3, 12), (24, 24, 24)])
def test_small_gc_grads_match_xla(gc, C, c_out, save_feats):
    """tests/test_pallas_chain.py's test of the same name, on the port:
    ``dense_chain_t_ep`` under autograd against ``jax.grad`` of
    ``_xla_impl_v2`` (the chain without an epilogue) at growth width 12 and
    24, the gradients coming back at the true gc's shapes."""
    shape = (1, 2, 8, 16)
    x, ws, bs, w5, b5 = _chain_gc(22, C, gc, c_out, shape)
    leaves = [_t(x), *_t(ws), *_t(bs), _t(w5), _t(b5)]
    for t in leaves:
        t.requires_grad_(True)
    y = dc.dense_chain_t_ep(leaves[0], leaves[1:5], leaves[5:9], leaves[9], leaves[10],
                            save_feats=save_feats)
    got = torch.autograd.grad((y ** 2).sum(), leaves)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(_xla_impl_v2(*a) ** 2), argnums=(0, 1, 2, 3, 4)))(
        _j(x), _j(ws), _j(bs), _j(w5), _j(b5))
    for u, v in zip(got, jax.tree.leaves(want)):
        assert u.shape == v.shape
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("gc", [12, 24])
def test_adjoint_and_conv5_adjoint_take_either_feats_layout(gc):
    """The kernels' layout (each growth segment padded to 16 or 32 lanes)
    and the plain one give the same adjoint: the plain sweep ignores the pad
    lanes of the gradient (noise here), and conv5's adjoint scatters w5's
    rows to the real lanes (zero rows at the pad lanes) and gathers dw5 back."""
    P = 16 if gc <= 16 else 32
    x, ws, bs, w5, _ = _chain_gc(30, 8, gc, 6, (1, 3, 5, 6))
    x, ws, bs, w5 = _t(x), _t(ws), _t(bs), _t(w5)
    feats = dc.chain_feats_plain(x, ws, bs)
    padded = dc.padded_width(feats, gc, P)
    assert padded.shape[-1] == 4 * P and torch.equal(dc.true_width(padded, gc), feats)
    g = torch.from_numpy(np.random.default_rng(31).normal(0, 1, padded.shape).astype(np.float32))
    want = dc.chain_spatial_bwd_plain(x, ws, bs, feats, dc.true_width(g, gc))
    got = dc.chain_spatial_bwd_plain(x, ws, bs, padded, g)
    for u, v in zip([got[0], *got[1], *got[2]], [want[0], *want[1], *want[2]]):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    dy5 = torch.from_numpy(np.random.default_rng(32).normal(0, 1, (1, 3, 5, 6, 6)).astype(np.float32))
    a = dc._conv5_adjoint(x, feats, w5, dy5, True)
    b = dc._conv5_adjoint(x, padded, w5, dy5, True)
    torch.testing.assert_close(b[0], a[0], rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(dc.true_width(b[2], gc), a[2], rtol=1e-6, atol=1e-6)
    assert not dc.true_width(b[2], gc).equal(b[2]) and b[2].reshape(1, 3, 5, 6, 4, P)[..., gc:].abs().max() == 0
    torch.testing.assert_close(b[3], a[3])


# ---------------------------------------------------------------------------
# the v1 spatial chain (conv5 outside): fused_dense_spatial
# ---------------------------------------------------------------------------


def _spatial_grads(x, ws, bs, g):
    leaves = [_t(x), *_t(ws), *_t(bs)]
    for t in leaves:
        t.requires_grad_(True)
    y = dc.fused_dense_spatial(leaves[0], leaves[1:5], leaves[5:])
    return y.detach().numpy(), [t.numpy() for t in torch.autograd.grad(y, leaves, _t(g))]


def test_fused_dense_spatial_matches_pallas_interpret():
    """JAX's ``fused_dense_spatial`` (the v1 kernel in interpret mode, its
    custom VJP) against the port's, forward and gradients, at the shape of
    tests/test_pallas_chain.py's ``test_custom_vjp_matches_xla_grads``."""
    x, ws, bs, *_ = _chain(40, 3, 3, (1, 1, 12, 16))
    g = np.random.default_rng(41).normal(0, 1, (1, 1, 12, 16, 128)).astype(np.float32)
    y, got = _spatial_grads(x, ws, bs, g)
    want_y, want = jax.jit(lambda a, g: (lambda o: (o[0], o[1](g)))(jax.vjp(fused_dense_spatial, *a)))(
        (_j(x), _j(ws), _j(bs)), _j(g))
    np.testing.assert_allclose(y, np.asarray(want_y), atol=2e-5)
    for u, v in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(u, np.asarray(v), rtol=1e-5, atol=2e-3)


@pytest.mark.parametrize("shape", [(2, 3, 6, 24), (3, 10, 24)])
def test_fused_dense_spatial_matches_xla(shape):
    """Against ``jax.vjp`` of ``_xla_impl`` at a width that is not a multiple
    of 16 (as the surrogate's 72-column latents), on a video and on images
    ``(N,H,W,C)``."""
    C = 4
    x, ws, bs, *_ = _chain(42, C, 3, shape[:-1] if len(shape) == 4 else shape[:-1])
    x = np.random.default_rng(43).normal(0, 1, shape + (C,)).astype(np.float32)
    g = np.random.default_rng(44).normal(0, 1, shape + (128,)).astype(np.float32)
    y, got = _spatial_grads(x, ws, bs, g)
    x5 = _j(x) if len(shape) == 4 else _j(x)[:, None]
    g5 = _j(g) if len(shape) == 4 else _j(g)[:, None]
    want_y = jax.jit(_xla_impl)(x5, _j(ws), _j(bs))
    want = _jax_vjp(_xla_impl, (x5, _j(ws), _j(bs)), g5)
    np.testing.assert_allclose(y, np.asarray(want_y).reshape(y.shape), atol=2e-5)
    _assert_bwd((torch.from_numpy(got[0]), [torch.from_numpy(u) for u in got[1:5]],
                 [torch.from_numpy(u) for u in got[5:]]),
                (np.asarray(want[0]).reshape(x.shape), want[1], want[2]))


def test_fused_dense_spatial_takes_growth_32_only():
    x, ws, bs, *_ = _chain_gc(45, 4, 12, 3, (1, 1, 4, 4))
    with pytest.raises(ValueError, match="growth width 12"):
        dc.fused_dense_spatial(_t(x), _t(ws), _t(bs))


@pytest.mark.parametrize("gc,dx_in", [(12, True), (24, True), (32, False)])
def test_backward_cost_model_counts_the_true_growth_width(gc, dx_in):
    """Below growth 32 the bounds of the adjoint and the spatial-only forward
    count the chain's own channels, not the kernels' pad lanes; the v1
    spatial chain's backward (``dx_in=False``) reads no gradient of x."""
    B, T, H, W, C = 2, 3, 5, 4, 24
    ones = torch.ones(1, 1, H, W, dtype=torch.float64)
    taps = torch.nn.functional.conv2d(ones, torch.ones(1, 1, 3, 3, dtype=torch.float64), padding=1).sum().item()
    macs = B * T * taps * sum((C + gc * k) * gc for k in range(4))
    n_params = sum(9 * (C + gc * k) * gc + gc for k in range(4))
    px = B * T * H * W
    ops, nbytes = chain_feats_cost(B, T, H, W, C, 4, gc)
    assert ops == pytest.approx(2 * macs, rel=1e-12) and nbytes == 4 * (px * (C + 4 * gc) + n_params)
    ops, nbytes = chain_bwd_cost(B, T, H, W, C, 4, gc, dx_in)
    assert ops == pytest.approx(4 * macs, rel=1e-12)
    assert nbytes == 4 * (px * (C + 4 * gc) + 2 * n_params) + 4 * px * (4 * gc + (2 if dx_in else 1) * C)
