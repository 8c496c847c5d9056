"""Every block family of the port (``selfc_tpu_torch/models/blocks.py``: the
whole ``subnet()`` table and ``HighOrderTNet1``) against the JAX package's,
the plain coupling branch those families take, and SelfC_GMM nets built
with the families whose chains reach the temporal-conv kernel (B6).

Parameters come from the JAX module's abstract ``init`` (``jax.eval_shape``)
filled with seeded numpy values (every leaf non-zero: the 'inn_xavier' init
zeroes conv5 and ``early_3d_layer``, which would hide them), carried over with
``load_jax_params``; both stacks see the same numpy input, fp32, CPU.

Tolerances: atol 2e-5 for one block (as tests/test_torch_models.py), 1e-4
where several blocks and an exp() compound (coupling, nets); a gradient
within 1e-4 of the largest gradient of the tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.models import blocks as jblocks
from selfc_tpu.models.coupling import InvBlockExp as JInvBlockExp
from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
from selfc_tpu.ops.conv import conv2d as jconv2d
from selfc_tpu_torch.models import blocks
from selfc_tpu_torch.models.coupling import InvBlockExp
from selfc_tpu_torch.models.inv_nets import SelfCNetGMM
from selfc_tpu_torch.ops.conv import conv2d_same_strided
from selfc_tpu_torch.ops import temporal_conv as tc
from selfc_tpu_torch.utils.jax_import import export_jax_grads, flatten_tree, load_jax_params
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
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in flatten_tree(tree).items()}


def _pair(jmod, tmod, x, seed=0):
    """(the JAX module's seeded tree, the port's module loaded with it);
    the port's parameter names and shapes must be the JAX tree's."""
    tree = jax.tree.map(np.asarray, seeded_tree(jmod, seed, jnp.asarray(x)))
    assert {k: tuple(p.shape) for k, p in tmod.named_parameters()} == _shapes(tree)
    load_jax_params(tmod, tree)
    return tree


# every name of the JAX table with its output width: 4 -> 6 channels, 4 -> 4
# where the block adds x
TABLE_CASES = [
    ("DBNet", 6), ("DB3DNet", 6), ("DB3DNet_P", 6), ("D2DTNet", 6), ("ResD2DTInput", 4),
    ("D2DNet", 6), ("D2DLTInput", 6), ("D2DTEnhanceInput", 6), ("HighOrderTNet", 6),
    ("FeatureCalapseBlock", 6), ("FeatureCalapseBlock_SmallC", 6), ("FeatureCalapseBlock_Fast", 6)]


def test_table_lists_every_jax_name():
    assert {n for n, _ in TABLE_CASES} == set(blocks._TABLE)


@pytest.mark.parametrize("name,c_out", TABLE_CASES, ids=[n for n, _ in TABLE_CASES])
def test_subnet_matches_jax(name, c_out):
    """16 x 16 frames: FeatureCollapse's /4 and HighOrderTNet's /8 take it,
    and HighOrderTNet's stride-2 convs meet the asymmetric SAME padding at
    every level. gc 8 is asked; the table gives 32 where the JAX one does.
    (The init does not matter here: the values are seeded.)"""
    x = _rand(1, (1, 3, 16, 16, 4))
    jm = jblocks.subnet(name, "xavier")(4, c_out, gc=8, name=None)
    tm = blocks.subnet(name, "xavier")(4, c_out, gc=8)
    tree = _pair(jm, tm, x)
    want = jax.jit(lambda t, v: jm.apply({"params": t}, v))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_high_order_tnet1_matches_jax():
    x = _rand(2, (1, 3, 16, 16, 5))
    jm = jblocks.HighOrderTNet1(5, 3)
    tm = blocks.HighOrderTNet1(5, 3)
    tree = _pair(jm, tm, x)
    assert tm.inner1_block.chain.gc == 64 and "down1.kernel" in _shapes(tree)
    want = jm.apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("hw", [(16, 16), (15, 9), (8, 6)])
def test_strided_same_conv_matches_flax(hw):
    """flax's 'SAME' at stride 2 pads (0, 1) at an even size and (1, 1) at
    an odd one; ``F.conv2d(padding=1)`` samples other pixels at an even
    size."""
    x = _rand(3, (2,) + hw + (5,))
    w, b = _rand(4, (3, 3, 5, 7), 0.3), _rand(5, (7,), 0.1)
    want = np.asarray(jconv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=(2, 2)))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    got = conv2d_same_strided(xt, wt, bt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    sym = torch.nn.functional.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), bt, stride=2,
                                     padding=1).permute(0, 2, 3, 1)
    assert sym.shape == got.shape
    assert np.allclose(sym.numpy(), want, atol=1e-5) == (hw[0] % 2 == 1 and hw[1] % 2 == 1)


@pytest.mark.parametrize("name", ["D2DLTInput", "FeatureCalapseBlock_Fast", "D2DTEnhanceInput"])
@pytest.mark.parametrize("rev", [False, True])
def test_plain_coupling_matches_jax(name, rev):
    """InvBlockExp with a family that has no fused epilogue: the plain
    branch, sigmoid scale and jac = +-sum(s)/(B*T)."""
    x = _rand(6, (1, 2, 8, 8, 51))
    jm = JInvBlockExp(51, 3, jblocks.subnet(name, "xavier"))
    tm = InvBlockExp(51, 3, blocks.subnet(name, "xavier"))
    assert not tm.use_ep
    tree = _pair(jm, tm, x)
    want, want_jac = jm.apply({"params": tree}, jnp.asarray(x), rev)
    t = torch.from_numpy(x)
    with torch.no_grad():
        (y1, y2), jac = tm((t[..., :3].contiguous(), t[..., 3:].contiguous()), rev)
    np.testing.assert_allclose(torch.cat([y1, y2], -1).numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(jac.item(), float(want_jac), rtol=1e-4, atol=1e-4)
    # the reverse inverts the forward
    with torch.no_grad():
        back, jr = tm(tm((t[..., :3].contiguous(), t[..., 3:].contiguous()), rev)[0], not rev)
    np.testing.assert_allclose(torch.cat(back, -1).numpy(), x, atol=1e-4)


def test_inn_kaiming_init():
    """'kaiming' (anything but 'xavier') gives conv1-4 kaiming_normal x0.1
    (std 0.1 sqrt(2 / fan_in)) and a zero conv5."""
    m = blocks.subnet("D2DLTInput", "kaiming")(40, 24, generator=torch.Generator().manual_seed(0))
    c = m.chain
    assert c.conv1.weight.shape == (3, 3, 40, 32) and c.conv4.weight.shape == (3, 3, 136, 32)
    assert c.conv5.weight.shape == (3, 168, 24) and c.early_3d_layer.weight.shape == (3, 3, 3, 32, 32)
    for conv, fan_in in ((c.conv1, 9 * 40), (c.conv4, 9 * 136)):
        std = conv.weight.std().item()
        assert abs(std / (0.1 * (2.0 / fan_in) ** 0.5) - 1) < 0.05, std
    assert c.conv5.weight.abs().sum().item() == 0 and c.early_3d_layer.weight.abs().sum().item() == 0
    xav = blocks.subnet("D2DLTInput", "xavier")(40, 24, generator=torch.Generator().manual_seed(0))
    std = xav.chain.conv1.weight.std().item()
    assert abs(std / (0.1 * (2.0 / (9 * 40 + 9 * 32)) ** 0.5) - 1) < 0.05, std


# ---------------------------------------------------------------------------
# SelfC_GMM nets whose coupling blocks take a family that reaches B6
# ---------------------------------------------------------------------------

NET = dict(scale=4, block_num=(1, 1), stp_blk_num=2, gmm_k=5)
B6_FAMILIES = ["D2DLTInput", "FeatureCalapseBlock_Fast", "D2DTEnhanceInput"]


@pytest.fixture(scope="module", params=B6_FAMILIES)
def net_pair(request):
    x = np.random.default_rng(10).random((1, 3, 32, 32, 3), dtype=np.float32)
    jm = JSelfCNetGMM(subnet_type=request.param, **NET)
    tm = SelfCNetGMM(subnet_type=request.param, device="cpu", **NET)
    tree = jax.tree.map(np.asarray, seeded_tree(jm, 11, jnp.asarray(x), method=jm.roundtrip))
    assert {k: tuple(p.shape) for k, p in tm.named_parameters()} == _shapes(tree)
    load_jax_params(tm, tree)
    return jm, tm, tree, x


def test_net_encode_matches_jax(net_pair):
    jm, tm, tree, x = net_pair
    want, want_jac = jax.jit(lambda t, v: jm.apply({"params": t}, v, method=jm.encode))(tree, jnp.asarray(x))
    with torch.no_grad():
        got, jac = tm.encode(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(jac.item(), float(want_jac), rtol=1e-4, atol=1e-3)


def test_net_decode_with_hf_matches_jax(net_pair):
    jm, tm, tree, _ = net_pair
    lr = np.round(np.random.default_rng(12).random((1, 3, 8, 8, 3)) * 255).astype(np.float32) / 255
    hf = _rand(13, (1, 3, 8, 8, 48), 0.5)
    want, want_y = jax.jit(lambda t, a, h: jm.apply({"params": t}, a, h, method=jm.decode_with_hf))(
        tree, jnp.asarray(lr), jnp.asarray(hf))
    tc.reset_launch_counts()
    with torch.no_grad():
        got, got_y = tm.decode_with_hf(torch.from_numpy(lr), torch.from_numpy(hf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-4)
    assert tc.launches == 0   # a CPU tensor takes the plain version


def test_net_gradient_matches_jax(net_pair):
    """One gradient of the whole tree (and of the input) through encode and
    decode_with_hf: the temporal conv's backward, the plain coupling's and
    the chains' against JAX's autodiff."""
    jm, tm, tree, x = net_pair
    r = _rand(14, (1, 3, 8, 8, 51))
    hf = _rand(15, (1, 3, 8, 8, 48), 0.5)

    def jloss(t, v):
        y, _ = jm.apply({"params": t}, v, method=jm.encode)
        hr, _ = jm.apply({"params": t}, y[..., :3], jnp.asarray(hf), method=jm.decode_with_hf)
        return jnp.mean(y * r) + jnp.mean(hr ** 2)

    want_t, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(tree, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = tm.encode(xt)
    hr, _ = tm.decode_with_hf(y[..., :3], torch.from_numpy(hf))
    (torch.mean(y * torch.from_numpy(r)) + torch.mean(hr ** 2)).backward()
    want = {k: np.asarray(v) for k, v in flatten_tree(want_t).items()}
    got = flatten_tree(export_jax_grads(tm))
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4 * scale, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want_x)).max())
