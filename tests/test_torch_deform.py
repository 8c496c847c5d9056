"""The fifth slice of the port: the modulated deformable conv
(``selfc_tpu_torch/ops/deform.py``), the deformable aggregations
(``DeformConvAgg``, ``GroupedGlobalDeformAgg``), the STP prior with them, and
``SelfCNetCodec(deart_net=True)``, against the JAX package, fp32, on the CPU.
The JAX side of the tests of ``tests/test_more_parity.py::TestDeformAgg`` is
repeated here against the port.

Inputs are numpy-seeded; offsets are drawn uniform in +-7 px, so taps leave
the frame, and the mask in [0, 2]. The modules' zero-initialised leaves are
seeded too (``seeded_tree`` fills every leaf): at their zero init the
deformable term is 0 and every offset an integer, which would check nothing.
Where the JAX function reaches its Pallas kernel (``deform_conv2d_pallas``,
the exact route of the JAX modules), it runs in interpret mode off the TPU.

Tolerances: one op atol 1e-5 (the same fp32 products in another order);
its gradients 1e-4 of max |ref|; a module atol 1e-5, its gradients 1e-4 of
max |ref| per leaf; the codec decode (prior, de-artifact net and an inverse
coupling block) atol 1e-4, as tests/test_torch_codec.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.models.agg import DeformConvAgg as JDeformConvAgg
from selfc_tpu.models.agg import GroupedGlobalDeformAgg as JGroupedGlobalDeformAgg
from selfc_tpu.models.inv_nets import SelfCNetCodec as JSelfCNetCodec
from selfc_tpu.models.stp import STPNet as JSTPNet
from selfc_tpu.ops import conv as jconv
from selfc_tpu.ops import deform as jdeform
from selfc_tpu_torch.models.agg import DeformConvAgg, GroupedGlobalDeformAgg
from selfc_tpu_torch.models.inv_nets import SelfCNetCodec, _CouplingNet
from selfc_tpu_torch.models.stp import STPNet
from selfc_tpu_torch.ops import deform as df
from selfc_tpu_torch.ops.conv import conv2d
from selfc_tpu_torch.utils.bench import make_deform
from selfc_tpu_torch.utils.jax_import import export_jax_params, flatten_tree, load_jax_params
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


def _j(t):
    return jnp.asarray(t.detach().numpy())


def _operands(seed, shape, C, c_out, spread=7.0):
    return make_deform(np.random.default_rng(seed), shape, C, c_out, "cpu", spread=spread)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,C,c_out", [((2, 13, 21), 5, 3), ((1, 6, 7), 4, 5), ((1, 9, 11), 32, 32)])
def test_deform_plain_matches_jax(shape, C, c_out):
    """The composition at odd shapes, with a bias; and the public op, which
    takes it for a CPU tensor."""
    x, off, mask, w, _ = _operands(1, shape, C, c_out)
    b = torch.from_numpy(np.random.default_rng(2).normal(0, 1, c_out).astype(np.float32))
    want = np.asarray(jdeform.deform_conv2d(_j(x), _j(off), _j(mask), _j(w), _j(b)))
    np.testing.assert_allclose(df.deform_conv2d_plain(x, off, mask, w, b).numpy(), want, atol=1e-5)
    np.testing.assert_allclose(df.deform_conv2d(x, off, mask, w, b).numpy(), want, atol=1e-5)


def test_deform_plain_matches_jax_pallas_kernel():
    """Against the JAX package's kernel itself (interpret mode off the TPU) at the
    shape of its own kernel test, unbounded offsets."""
    x, off, mask, w, _ = _operands(3, (2, 12, 16), 8, 8)
    assert jdeform.deform_pallas_ok(tuple(x.shape), 8)
    want = np.asarray(jdeform.deform_conv2d_pallas(_j(x), _j(off), _j(mask), _j(w)))
    np.testing.assert_allclose(df.deform_conv2d_plain(x, off, mask, w).numpy(), want, atol=1e-5)


def test_zero_offset_equals_conv2d():
    """Zero offsets and mask 1: a SAME 3x3 conv (both zero-pad outside), the
    port's ``conv2d``, which is the JAX package's."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((1, 6, 7, 4), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 4, 5)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    got = df.deform_conv2d(x, torch.zeros(1, 6, 7, 18), torch.ones(1, 6, 7, 9), w, b)
    want = conv2d(x, w, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(want.numpy(), np.asarray(jconv.conv2d(_j(x), _j(w), _j(b))), atol=1e-5)


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of the JAX composition for x, offset, mask and weight under
    the loss <out, g>, at an odd shape and at the de-artifact width."""
    out = {}
    for key, shape, C, c_out in (("odd", (2, 13, 21), 5, 3), ("c32", (1, 9, 11), 32, 32)):
        ops = _operands(5, shape, C, c_out)
        x, off, mask, w, g = ops

        def loss(*a, g=g):
            return jnp.sum(jdeform.deform_conv2d(*a) * _j(g))

        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(_j(x), _j(off), _j(mask), _j(w))
        out[key] = ops, [np.asarray(v) for v in grads]
    return out


@pytest.mark.parametrize("key", ["odd", "c32"])
@pytest.mark.parametrize("impl", ["closed_form", "autograd_function", "autograd_of_plain"])
def test_deform_gradients_match_jax(jax_grads, impl, key):
    """The closed-form adjoint (what the CUDA backward computes), the op's
    autograd.Function on the CPU (which takes it), and autograd through the
    composition, each against jax.grad: x, offset, mask, weight."""
    (x, off, mask, w, g), want = jax_grads[key]
    if impl == "closed_form":
        got = df.deform_conv2d_bwd_plain(x, off, mask, w, g)
    else:
        leaves = [t.clone().requires_grad_(True) for t in (x, off, mask, w)]
        fn = df.deform_conv2d if impl == "autograd_function" else df.deform_conv2d_plain
        got = torch.autograd.grad(fn(*leaves), leaves, g)
    for name, u, v in zip(("dx", "doffset", "dmask", "dweight"), got, want):
        assert u.shape == v.shape and u.dtype == torch.float32, name
        assert _rel(u.numpy(), v) <= 1e-4, (name, _rel(u.numpy(), v))


def test_deform_gradcheck_fp64():
    """The autograd.Function's closed-form adjoint against finite
    differences, fp64, offsets away from the integers where the bilinear
    weights have their kinks."""
    x, off, mask, w, _ = _operands(6, (1, 3, 4), 2, 3, spread=2.0)
    off = off.double()
    off = torch.where((off - off.round()).abs() < 0.05, off + 0.1, off)
    leaves = [t.double().requires_grad_(True) for t in (x, off, mask, w)]
    assert torch.autograd.gradcheck(df.deform_conv2d, leaves, eps=1e-6, atol=1e-6)


def test_deform_windowed_matches_jax():
    """The windowed formulation: values and offset gradients against the
    JAX package's, and against the exact op while every displacement stays
    inside the window (|offset| < 0.9 and a tap's +-1 within radius 2)."""
    x, off, mask, w, _ = _operands(7, (2, 10, 9), 5, 4, spread=0.9)
    b = torch.from_numpy(np.random.default_rng(8).normal(0, 1, 4).astype(np.float32))
    want = np.asarray(jdeform.deform_conv2d_windowed(_j(x), _j(off), _j(mask), _j(w), _j(b), radius=2))
    got = df.deform_conv2d_windowed(x, off, mask, w, b, radius=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), df.deform_conv2d(x, off, mask, w, b).numpy(), atol=1e-4)
    g_want = jax.jit(jax.grad(lambda o: jnp.sum(
        jdeform.deform_conv2d_windowed(_j(x), o, _j(mask), _j(w), _j(b), radius=2) ** 2)))(_j(off))
    o = off.clone().requires_grad_(True)
    (df.deform_conv2d_windowed(x, o, mask, w, b, radius=2) ** 2).sum().backward()
    assert _rel(o.grad.numpy(), g_want) <= 1e-4


@pytest.mark.parametrize("fault,error", [("dtype", ValueError), ("shape", ValueError), ("layout", ValueError),
                                         ("float64", TypeError)])
def test_kernel_wrapper_refuses_what_the_kernels_do_not_take(fault, error):
    """The launch path's checks (they run before any library is loaded)."""
    x, off, mask, w, _ = _operands(9, (1, 5, 6), 4, 4)
    bad = {"dtype": (x, off.bfloat16(), mask, w), "shape": (x, off[..., :9].contiguous(), mask, w),
           "layout": (x, off, mask, w.transpose(2, 3)), "float64": (x.double(), off, mask, w)}[fault]
    with pytest.raises(error):
        df._validate(*bad)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


def _module_pair(jcls, tcls, radius, seed, x):
    """The JAX module takes the clip length from its init input, the port's
    at construction."""
    jm = jcls(8, deform_radius=radius)
    tree = seeded_tree(jm, seed, jnp.asarray(x))
    tm = tcls(8, frames=x.shape[1], deform_radius=radius)
    load_jax_params(tm, tree)
    return jm, tree, tm


def _japply(jm, tree, x, **kw):
    """One jitted program: eager flax ``apply`` of these modules takes
    several times as long on the CPU."""
    return jax.tree.map(np.asarray, jax.jit(lambda p, v: jm.apply({"params": p}, v, **kw))(tree, jnp.asarray(x)))


@pytest.mark.parametrize("radius", [None, 2])
@pytest.mark.parametrize("jcls,tcls", [(JDeformConvAgg, DeformConvAgg),
                                       (JGroupedGlobalDeformAgg, GroupedGlobalDeformAgg)],
                         ids=["deform", "grouped_global_deform"])
def test_deform_agg_matches_jax(jcls, tcls, radius):
    """The same parameter tree (names, shapes, every leaf seeded), the same
    clip: the exact route (the JAX package's Pallas kernel) and the windowed
    one. The aggregation must move the output away from the residual."""
    x = np.random.default_rng(10).normal(0, 1, (1, 3, 8, 8, 8)).astype(np.float32)
    jm, tree, tm = _module_pair(jcls, tcls, radius, 11, x)
    want = _japply(jm, tree, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(want - x).max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_grouped_global_deform_agg_gradients_match_jax():
    """jax.grad of <out, g> for the clip and every parameter, against the
    port's autograd through the op's closed-form adjoint; a clip of two
    frames (four deformable convs, not nine, in the JAX program)."""
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (1, 2, 8, 8, 8)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    jm, tree, tm = _module_pair(JGroupedGlobalDeformAgg, GroupedGlobalDeformAgg, None, 13, x)
    gx_want, gp_want = jax.jit(jax.grad(
        lambda v, p: jnp.sum(jm.apply({"params": p}, v) * jnp.asarray(g)), argnums=(0, 1)))(jnp.asarray(x), tree)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tm(xt) * torch.from_numpy(g)).sum().backward()
    assert _rel(xt.grad.numpy(), gx_want) <= 1e-4
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    for k, v in flatten_tree(jax.tree.map(np.asarray, gp_want)).items():
        assert _rel(got[k], v) <= 1e-4, (k, _rel(got[k], v))


def test_deform_agg_refuses_another_clip_length():
    with pytest.raises(ValueError, match="built for 3"):
        GroupedGlobalDeformAgg(8)(torch.zeros(1, 4, 8, 8, 8))


@pytest.mark.parametrize("kind", ["deform", "grouped_global_deform"])
def test_stp_net_deform_matches_jax(kind):
    """The STP prior with a deformable global module (no shipped config uses
    one), cut to hidden 16, growth 8, two blocks, an l2 tail."""
    lr = np.random.default_rng(14).random((1, 3, 8, 8, 3), dtype=np.float32)
    kw = dict(scale=2, stp_blk_num=2, fh_loss="l2", global_module=kind, hidden_c=16, gc=8)
    jm = JSTPNet(**kw)
    tree = seeded_tree(jm, 15, jnp.asarray(lr))
    tm = STPNet(**kw)
    load_jax_params(tm, tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(lr)).numpy()
    np.testing.assert_allclose(got, _japply(jm, tree, lr), atol=1e-4)


# ---------------------------------------------------------------------------
# SelfCNetCodec(deart_net=True)
# ---------------------------------------------------------------------------

SMALL = dict(scale=2, block_num=(1,), stp_blk_num=2)


@pytest.fixture(scope="module")
def deart_stacks():
    x = np.random.default_rng(16).random((1, 3, 16, 16, 3), dtype=np.float32)
    jm = JSelfCNetCodec(deart_net=True, **SMALL)
    tree = seeded_tree(jm, 17, jnp.asarray(x), method=jm.roundtrip)
    tm = SelfCNetCodec(device="cpu", deart_net=True, **SMALL)
    load_jax_params(tm, tree)
    return jm, tree, tm.eval()


def test_codec_deart_tree_matches_jax(deart_stacks):
    """The port builds JAX's parameter tree (names and shapes of
    ``jax.eval_shape``), the de-artifact leaves included, and carries it
    both ways as a strict copy."""
    jm, tree, tm = deart_stacks
    want = flatten_tree(tree)
    assert {k: v.shape for k, v in want.items()} == {k: tuple(p.shape) for k, p in tm.named_parameters()}
    deart = sorted(k for k in want if k.startswith("deart_"))
    assert deart[0] == "deart_0.chain.conv1.bias" and "deart_1.offset_w" in deart
    assert {k.split(".")[0] for k in deart} == {"deart_0", "deart_1", "deart_2"}
    back = flatten_tree(export_jax_params(tm))
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)


def test_codec_deart_decode_matches_jax(deart_stacks):
    """``decode`` cleans the LR with the de-artifact net and hands the
    cleaned LR to both the prior and the inverse coupling; fh_loss l2 draws
    nothing, so the whole decode is comparable."""
    jm, tree, tm = deart_stacks
    lr = np.round(np.random.default_rng(18).random((1, 3, 8, 8, 3), dtype=np.float32) * 255) / 255
    want, want_hf = _japply(jm, tree, lr, method=jm.decode, rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got, hf = tm.decode(torch.from_numpy(lr))
        plain_hr, _ = _CouplingNet.decode(tm, torch.from_numpy(lr))  # without the net
    np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert np.abs(plain_hr.numpy() - np.asarray(want)).max() > 1e-2  # the net did something
