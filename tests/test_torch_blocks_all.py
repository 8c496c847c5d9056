"""The plain coupling branch the port's block families take, and SelfC_GMM
nets built with the families whose chains reach the temporal-conv kernel
(B6), against the JAX package's (each family alone: test_torch_subnets.py).

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
from selfc_tpu_torch.models import blocks
from selfc_tpu_torch.models.coupling import InvBlockExp
from selfc_tpu_torch.models.inv_nets import SelfCNetGMM
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
