"""The port's modules (selfc_tpu_torch.models) against the JAX package's:
the parameter tree has the JAX module's names and shapes and seeded numpy
values, is carried over with ``load_jax_params``, and both stacks see the
same numpy input, fp32, CPU.

The values are seeded rather than initialised because the 'inn_xavier' init
zeroes conv5, which makes every chain output zero and a comparison blind.

Tolerances: atol 2e-5 for one chain (as tests/test_pallas_chain.py), 1e-4
where several chains and an exp()/divide compound (coupling, STP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.models.agg import GlobalAgg as JGlobalAgg
from selfc_tpu.models.blocks import D2DT as JD2DT
from selfc_tpu.models.blocks import subnet as jsubnet
from selfc_tpu.models.coupling import InvBlockExp as JInvBlockExp
from selfc_tpu.models.stp import STPNet as JSTPNet
from selfc_tpu_torch.models.agg import GlobalAgg
from selfc_tpu_torch.models.blocks import D2DT, subnet
from selfc_tpu_torch.models.coupling import InvBlockExp
from selfc_tpu_torch.models.stp import STPNet
from selfc_tpu_torch.utils.jax_import import load_jax_params


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


def seeded_tree(module, seed, *args, **kw):
    """The flax module's parameter tree (names and shapes from an abstract
    ``init``, which computes nothing) filled with seeded numpy values:
    fan-in scaled normal weights, N(0, 0.05) biases. Every conv is non-zero,
    so no chain output is blind."""
    rng = np.random.default_rng(seed)
    keys = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: module.init(keys, *args, **kw))["params"]

    def fill(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 1
        std = 0.05 if len(leaf.shape) == 1 else fan_in ** -0.5
        return rng.normal(0, std, leaf.shape).astype(np.float32)

    return jax.tree.map(fill, shapes)


def _apply(module, tree, *args, **kw):
    return module.apply({"params": tree}, *args, **kw)


@pytest.mark.parametrize("c_in,c_out,init", [(3, 48, "inn_xavier"),
                                             (48, 3, "inn_xavier"),
                                             (64, 64, "plain_xavier")])
def test_d2dt_matches_jax(c_in, c_out, init):
    x = _rand(1, (1, 3, 8, 12, c_in))
    jm = JD2DT(c_in, c_out, 32, init)
    tree = seeded_tree(jm, 0, jnp.asarray(x))
    tm = D2DT(c_in, c_out, 32, init)
    load_jax_params(tm, tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(_apply(jm, tree, jnp.asarray(x))),
                               atol=2e-5)


@pytest.mark.parametrize("init,conv5_zero", [("inn_xavier", True), ("plain_xavier", False)])
def test_d2dt_init_modes(init, conv5_zero):
    m = D2DT(8, 6, 32, init, torch.Generator().manual_seed(0))
    assert (m.chain.conv5.weight.abs().sum().item() == 0) == conv5_zero
    assert m.chain.conv1.weight.shape == (3, 3, 8, 32)
    assert m.chain.conv4.weight.shape == (3, 3, 8 + 96, 32)
    assert m.chain.conv5.weight.shape == (3, 8 + 128, 6)
    assert all(getattr(m.chain, f"conv{i}").bias.abs().sum().item() == 0 for i in range(1, 6))


def _coupling_pair():
    jm = JInvBlockExp(51, 3, jsubnet("D2DTNet", "xavier"))
    x = _rand(2, (1, 2, 8, 12, 51))
    tree = seeded_tree(jm, 0, jnp.asarray(x))
    tm = InvBlockExp(51, 3, subnet("D2DTNet", "xavier"))
    load_jax_params(tm, tree)
    return jm, tm, tree, x


@pytest.mark.parametrize("rev", [False, True])
def test_inv_block_matches_jax(rev):
    jm, tm, tree, x = _coupling_pair()
    want, want_jac = _apply(jm, tree, jnp.asarray(x), rev)
    t = torch.from_numpy(x)
    with torch.no_grad():
        (y1, y2), jac = tm((t[..., :3].contiguous(), t[..., 3:].contiguous()), rev)
    got = torch.cat([y1, y2], -1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    # log-jac: sum(log(exp(s))) over 4608 values against sum(s)
    np.testing.assert_allclose(jac.item(), float(want_jac), rtol=1e-4, atol=1e-3)


def test_inv_block_reverse_inverts_forward():
    _, tm, _, x = _coupling_pair()
    t = torch.from_numpy(x)
    pair = (t[..., :3].contiguous(), t[..., 3:].contiguous())
    with torch.no_grad():
        fwd, jf = tm(pair, False)
        back, jr = tm(fwd, True)
    np.testing.assert_allclose(back[0].numpy(), pair[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(back[1].numpy(), pair[1].numpy(), atol=1e-4)
    assert abs(jf.item() + jr.item()) < 1e-3


# the codec prior's GlobalAgg(24), at a decode tile's 270 x 240 cut to a
# size that is not a multiple of the 32 x 32 pool either
@pytest.mark.parametrize("hw,c", [((40, 36), 16), ((8, 12), 16), ((34, 30), 24)],
                         ids=["hw0", "hw1", "codec24"])
def test_global_agg_matches_jax(hw, c):
    x = _rand(3, (2, 3) + hw + (c,))
    jm = JGlobalAgg(c)
    tree = seeded_tree(jm, 0, jnp.asarray(x))
    tm = GlobalAgg(c)
    load_jax_params(tm, tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(_apply(jm, tree, jnp.asarray(x))),
                               atol=1e-5)


# the codec's prior (model SelfC_GMM_Codec): scale 2, hidden 24, growth 12
CODEC_STP = dict(scale=2, hidden_c=24, gc=12)


@pytest.mark.parametrize("fh_loss,global_module,extra", [("gmm", "nonlocal", {}),
                                                         ("gmm_thin", "nonlocal", {}),
                                                         ("l2", "none", {}),
                                                         ("l2", "nonlocal", CODEC_STP)],
                         ids=["gmm-nonlocal", "gmm_thin-nonlocal", "l2-none", "codec"])
def test_stp_net_matches_jax(fh_loss, global_module, extra):
    lr = _rand(4, (1, 3, 8, 12, 3), 0.3) + 0.5
    kw = dict(scale=4, stp_blk_num=3, fh_loss=fh_loss, gmm_k=5,
              global_module=global_module)
    kw.update(extra)
    jm = JSTPNet(**kw)
    tree = seeded_tree(jm, 0, jnp.asarray(lr))
    tm = STPNet(**kw)
    load_jax_params(tm, tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(lr))
    want = np.asarray(_apply(jm, tree, jnp.asarray(lr)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("kind", ["deform", "grouped_global_deform"])
def test_stp_deform_builds_the_jax_tree(kind):
    """The deformable global modules build at the default width with the
    JAX prior's leaf names and shapes (a clip of 3 frames, the JAX model
    wrappers' default); tests/test_torch_deform.py holds their values."""
    lr = jnp.zeros((1, 3, 8, 8, 3))
    shapes = jax.eval_shape(lambda: JSTPNet(global_module=kind).init(jax.random.PRNGKey(0), lr))["params"]
    want = {".".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: tuple(p.shape) for k, p in STPNet(global_module=kind).named_parameters()}
    assert got == want and any(k.startswith("global_m1.offset_w") for k in got)


def test_subnet_factory_names_unported_types():
    with pytest.raises(NotImplementedError, match="A23"):
        subnet("DBNet")
