"""Every block family of the port (``selfc_tpu_torch/models/blocks.py``: the
whole ``subnet()`` table and ``HighOrderTNet1``) against the JAX package's,
HighOrderTNet's stride-2 'SAME' conv against flax's, and the 'inn_kaiming'
init (the coupling and the nets built with these families are in
test_torch_blocks_all.py).

Parameters come from the JAX module's abstract ``init`` (``jax.eval_shape``)
filled with seeded numpy values (every leaf non-zero: the 'inn_xavier' init
zeroes conv5 and ``early_3d_layer``, which would hide them), carried over with
``load_jax_params``; both stacks see the same numpy input, fp32, CPU.

Tolerances: atol 2e-5 for one block (as tests/test_torch_models.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.models import blocks as jblocks
from selfc_tpu.ops.conv import conv2d as jconv2d
from selfc_tpu_torch.models import blocks
from selfc_tpu_torch.ops.conv import conv2d_same_strided
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
