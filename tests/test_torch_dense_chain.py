"""The port's dense chain (selfc_tpu_torch.ops.dense_chain) against the JAX
package: the XLA formulation ``_xla_impl_v2_ep`` and the Pallas kernel in
interpret mode, on the same numpy inputs, fp32, on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is compared with that plain version on the GPU by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.ops.pallas_chain import _pallas_impl_v2, _xla_impl_v2_ep, pad_gc_params
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.utils.bench import chain_cost


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

MODES = ("none", "add", "sub_from", "sig_exp", "sig_exp_neg", "mul_add", "sub_mul")
WIDTHS = ((3, 48), (48, 3), (64, 64))
# atol as tests/test_pallas_chain.py uses for kernel-vs-XLA: the three
# implementations sum the same fp32 products in different orders
ATOL = 2e-5


def _chain(seed, C, c_out, shape):
    rng = np.random.default_rng(seed)
    f = lambda s, sc=0.1: rng.normal(0, sc, s).astype(np.float32)  # noqa: E731
    # fan-in scaled weights keep every activation of order one, so the
    # absolute tolerance means the same at every width
    ws = [f((3, 3, C + 32 * k, 32), (9 * (C + 32 * k)) ** -0.5) for k in range(4)]
    bs = [f((32,)) for _ in range(4)]
    w5, b5 = f((3, C + 128, c_out), (3 * (C + 128)) ** -0.5), f((c_out,))
    x = f(shape + (C,), 1.0)
    a, m = f(shape + (c_out,), 1.0), f(shape + (c_out,), 1.0)
    return x, ws, bs, w5, b5, a, m


def _torch_out(fn, x, ws, bs, w5, b5, mode, clamp, a, m):
    t = torch.from_numpy
    n = dc.EP_AUX[mode]
    with torch.no_grad():
        y = fn(t(x), [t(w) for w in ws], [t(b) for b in bs], t(w5), t(b5),
               mode, clamp, t(a) if n >= 1 else None, t(m) if n >= 2 else None)
    return y.numpy()


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("C,c_out", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_xla_oracle(mode, C, c_out, T):
    # W = 12 is not a multiple of 16
    x, ws, bs, w5, b5, a, m = _chain(1, C, c_out, (1, T, 8, 12))
    clamp = 0.8
    aux = [jnp.asarray(v) for v in (a, m)[:dc.EP_AUX[mode]]]
    want = _xla_impl_v2_ep(
        mode, clamp, jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), jnp.asarray(w5), jnp.asarray(b5), *aux)
    got = _torch_out(dc.dense_chain_t_ep_plain, x, ws, bs, w5, b5, mode, clamp, a, m)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("C,c_out,T", [(3, 48, 3), (48, 3, 1), (64, 64, 3)])
@pytest.mark.parametrize("mode", MODES)
def test_wrapper_matches_pallas_interpret(mode, C, c_out, T):
    x, ws, bs, w5, b5, a, m = _chain(2, C, c_out, (1, T, 8, 12))
    n = dc.EP_AUX[mode]
    want = _pallas_impl_v2(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        jnp.asarray(w5), jnp.asarray(b5), ep=mode, clamp=1.0,
        a=jnp.asarray(a) if n >= 1 else None, m=jnp.asarray(m) if n >= 2 else None)
    # a CPU tensor takes the wrapper to the plain version
    got = _torch_out(dc.dense_chain_t_ep, x, ws, bs, w5, b5, mode, 1.0, a, m)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_small_growth_width_runs_plain():
    """gc < 32 (the codec prior) is served by the plain version."""
    rng = np.random.default_rng(3)
    f = lambda s: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))  # noqa: E731
    C, gc, c_out = 24, 12, 24
    ws = [f((3, 3, C + gc * k, gc)) for k in range(4)]
    bs = [f((gc,)) for _ in range(4)]
    y = dc.dense_chain_t_ep(f((1, 2, 6, 6, C)), ws, bs, f((3, C + 4 * gc, c_out)),
                            f((c_out,)))
    assert y.shape == (1, 2, 6, 6, c_out) and torch.isfinite(y).all()


def _chain_gc(seed, C, gc, c_out, shape):
    """The inputs of tests/test_pallas_chain.py::test_small_gc_chain_matches_xla
    (N(0, 0.1) parameters, N(0, 1) input) with epilogue operands."""
    rng = np.random.default_rng(seed)
    f = lambda s, sc=0.1: rng.normal(0, sc, s).astype(np.float32)  # noqa: E731
    ws = [f((3, 3, C + gc * k, gc)) for k in range(4)]
    bs = [f((gc,)) for _ in range(4)]
    w5, b5 = f((3, C + 4 * gc, c_out)), f((c_out,))
    x = f(shape + (C,), 1.0)
    a, m = f(shape + (c_out,), 1.0), f(shape + (c_out,), 1.0)
    return x, ws, bs, w5, b5, a, m


# the cases of tests/test_pallas_chain.py::test_small_gc_chain_matches_xla
SMALL_GC = ((12, 3, 12), (12, 12, 3), (24, 24, 24))


@pytest.mark.parametrize("gc,C,c_out", SMALL_GC)
@pytest.mark.parametrize("mode", ("none", "sub_mul"))
def test_small_gc_plain_matches_xla_oracle(mode, gc, C, c_out):
    """The plain chain at the true growth width (the codec prior's gc 12,
    and 24) against the XLA formulation, atol 2e-5 as the gc = 32 cases."""
    x, ws, bs, w5, b5, a, m = _chain_gc(21, C, gc, c_out, (1, 3, 12, 16))
    aux = [jnp.asarray(v) for v in (a, m)[:dc.EP_AUX[mode]]]
    want = _xla_impl_v2_ep(
        mode, 0.8, jnp.asarray(x), tuple(map(jnp.asarray, ws)),
        tuple(map(jnp.asarray, bs)), jnp.asarray(w5), jnp.asarray(b5), *aux)
    got = _torch_out(dc.dense_chain_t_ep, x, ws, bs, w5, b5, mode, 0.8, a, m)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("gc,C,c_out", SMALL_GC[1:2])
def test_small_gc_plain_matches_padded_pallas_interpret(gc, C, c_out):
    """What the TPU runs at gc < 32: the parameters zero-padded to 32-lane
    growth segments (``pad_gc_params``) through the interpret-mode kernel;
    the port's plain chain at the true gc gives the same, atol 2e-5."""
    x, ws, bs, w5, b5, *_ = _chain_gc(22, C, gc, c_out, (1, 3, 12, 16))
    pws, pbs, pw5 = pad_gc_params(tuple(map(jnp.asarray, ws)),
                                  tuple(map(jnp.asarray, bs)), jnp.asarray(w5))
    want = _pallas_impl_v2(jnp.asarray(x), tuple(pws), tuple(pbs), pw5, jnp.asarray(b5))
    got = _torch_out(dc.dense_chain_t_ep, x, ws, bs, w5, b5, "none", 1.0, None, None)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_unknown_mode_raises():
    x, ws, bs, w5, b5, a, m = _chain(4, 3, 48, (1, 1, 4, 4))
    t = torch.from_numpy
    with pytest.raises(ValueError):
        dc.dense_chain_t_ep(t(x), [t(w) for w in ws], [t(b) for b in bs],
                            t(w5), t(b5), "mul", 1.0, t(a), t(m))


def test_launch_counter_counts_only_kernel_launches():
    before = dc.launches
    x, ws, bs, w5, b5, a, m = _chain(5, 3, 48, (1, 1, 4, 4))
    _torch_out(dc.dense_chain_t_ep, x, ws, bs, w5, b5, "none", 1.0, a, m)
    assert dc.launches == before  # the CPU path launches nothing


def _valid_args(C=8, c_out=6, shape=(1, 2, 4, 5)):
    t = torch.from_numpy
    x, ws, bs, w5, b5, a, m = _chain(6, C, c_out, shape)
    return [t(x), [t(w) for w in ws], [t(b) for b in bs], t(w5), t(b5), "mul_add", t(a), t(m)]


def test_kernel_argument_checks_accept_valid_arguments():
    dc._validate(*_valid_args())


@pytest.mark.parametrize("gc", [12, 1, 13, 24])
def test_kernel_argument_checks_accept_small_growth_width(gc):
    """The forward kernels take any growth width in 1..32."""
    t = torch.from_numpy
    x, ws, bs, w5, b5, a, m = _chain_gc(6, 8, gc, 6, (1, 2, 4, 5))
    dc._validate(t(x), [t(w) for w in ws], [t(b) for b in bs], t(w5), t(b5), "mul_add", t(a), t(m))


def test_kernel_argument_checks_reject_growth_width_over_32():
    t = torch.from_numpy
    x, ws, bs, w5, b5, a, m = _chain_gc(6, 8, 48, 6, (1, 2, 4, 5))
    with pytest.raises(ValueError, match="growth width 48"):
        dc._validate(t(x), [t(w) for w in ws], [t(b) for b in bs], t(w5), t(b5), "mul_add", t(a), t(m))


def test_small_growth_width_backward_refused_on_the_card():
    """The adjoint and the spatial-only forward kernels take every growth
    width the forward takes (the refusal of gc < 32 is gone): the validator
    that ``chain_feats`` and ``chain_spatial_bwd`` run on a CUDA tensor
    passes gc 12 and 32 and refuses only gc > 32, before any launch."""
    t = torch.from_numpy
    x, ws, bs, *_ = _chain_gc(7, 24, 12, 24, (1, 2, 4, 5))
    dc._validate_spatial(t(x), [t(w) for w in ws], [t(b) for b in bs])
    x, ws, bs, *_ = _valid_args()
    dc._validate_spatial(x, ws, bs)
    x, ws, bs, *_ = _chain_gc(7, 24, 48, 24, (1, 2, 4, 5))
    with pytest.raises(ValueError, match="growth width 48"):
        dc._validate_spatial(t(x), [t(w) for w in ws], [t(b) for b in bs])


@pytest.mark.parametrize("fault,error", [
    ("x_dtype", TypeError), ("x_rank", ValueError), ("a_strided", ValueError),
    ("m_missing", TypeError), ("w3_shape", ValueError), ("b5_dtype", ValueError),
    ("gc_16", ValueError), ("x_misaligned", ValueError), ("three_convs", ValueError),
])
def test_kernel_argument_checks_reject(fault, error):
    """What the CUDA path refuses (checked before any launch, so testable
    here): wrong type, rank, shape, layout, alignment, growth width."""
    x, ws, bs, w5, b5, mode, a, m = _valid_args()
    if fault == "x_dtype":
        x = x.double()
    elif fault == "x_rank":
        x = x[0]
    elif fault == "a_strided":
        a = torch.cat([a, a], -1)[..., :a.shape[-1]]
    elif fault == "m_missing":
        m = None
    elif fault == "w3_shape":
        ws[2] = ws[2][:, :, :-1]
    elif fault == "b5_dtype":
        b5 = b5.bfloat16()
    elif fault == "gc_16":
        ws = [w[..., :16].contiguous() for w in ws]
    elif fault == "x_misaligned":
        x = torch.cat([x.flatten()[:1], x.flatten()])[1:].view(x.shape)
    elif fault == "three_convs":
        ws, bs = ws[:3], bs[:3]
    with pytest.raises(error):
        dc._validate(x, ws, bs, w5, b5, mode, a, m)


def test_kernel_path_is_forward_only():
    """No longer forward-only: the argument checks accept tensors that
    require grad (the gradient has kernels of its own), and the wrapper's
    result carries a ``grad_fn``."""
    x, ws, bs, w5, b5, mode, a, m = _valid_args()
    ws[0].requires_grad_(True)
    dc._validate(x, ws, bs, w5, b5, mode, a, m)
    y = dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 1.0, a, m)
    assert y.grad_fn is not None and y.requires_grad
    y.sum().backward()
    assert ws[0].grad is not None and ws[0].grad.shape == ws[0].shape
    with torch.no_grad():
        assert dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, 1.0, a, m).grad_fn is None


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 5, 4), (1, 7, 9, 11)])
@pytest.mark.parametrize("C,c_out", WIDTHS)
def test_cost_model_counts_only_taps_inside_the_clip(C, c_out, shape):
    """``chain_cost`` against a count made by convolving ones: a tap that
    meets the zero padding is no work, so the roofline bound built on the
    count is never above what the function needs."""
    B, T, H, W = shape
    conv = torch.nn.functional.conv3d
    ones = torch.ones(1, 1, T, H, W, dtype=torch.float64)
    taps_hw = conv(ones, torch.ones(1, 1, 1, 3, 3, dtype=torch.float64), padding=(0, 1, 1)).sum().item()
    taps_t = conv(ones, torch.ones(1, 1, 3, 1, 1, dtype=torch.float64), padding=(1, 0, 0)).sum().item()
    macs = B * (taps_hw * sum((C + 32 * k) * 32 for k in range(4)) + taps_t * (C + 128) * c_out)
    ops, nbytes = chain_cost(B, T, H, W, C, c_out, 2, 4)
    assert ops == pytest.approx(2 * macs, rel=1e-12)
    n_params = sum(9 * (C + 32 * k) * 32 + 32 for k in range(4)) + 3 * (C + 128) * c_out + c_out
    assert nbytes == 4 * (B * T * H * W * (C + 3 * c_out) + n_params)


@pytest.mark.parametrize("gc", [12, 24])
def test_cost_model_counts_the_true_growth_width(gc):
    """At gc < 32 the bound counts the chain's own channels, not the
    kernels' pad lanes: the same count as above with gc for 32."""
    B, T, H, W, C, c_out = 2, 3, 5, 4, 24, 24
    taps_hw = (3 * H - 2) * (3 * W - 2) * B * T
    taps_t = (3 * T - 2) * B * H * W
    macs = taps_hw * sum((C + gc * k) * gc for k in range(4)) + taps_t * (C + 4 * gc) * c_out
    ops, nbytes = chain_cost(B, T, H, W, C, c_out, 0, 4, gc)
    assert ops == pytest.approx(2 * macs, rel=1e-12)
    n_params = sum(9 * (C + gc * k) * gc + gc for k in range(4)) + 3 * (C + 4 * gc) * c_out + c_out
    assert nbytes == 4 * (B * T * H * W * (C + c_out) + n_params)
