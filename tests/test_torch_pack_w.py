"""W-packing in the port (``network_G.pack_w``; JAX ``_pick_pack_w``,
``_pack_w``, ``stripe_w`` and ``models/inv_nets._chain_pair``) against the
JAX package, fp32 on the CPU, with inputs made from numpy seeds.

On the CPU the port's striped chain runs its plain versions (unpack, run per
image, pack); the JAX side runs the Pallas kernels with their stripe masks
interpreted, as ``tests/test_pallas_chain.py`` runs them, and the nets on
their XLA path. The CUDA kernels' masks are held to the same plain versions
by ``tests/test_torch_cuda_sources_on_cpu.py`` (their sources compiled for
the CPU) and on the card by ``chip_smoke.py``.

Tolerances: a chain's forward and features 2e-5 abs (the JAX tests'); the
adjoint and every gradient 1e-4 of max |ref|; a net 1e-4 abs and its whole
gradient 1e-4 in relative l2 (``tests/test_torch_chain_variants.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.models.inv_nets import SelfCNetCodec as JSelfCNetCodec
from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
from selfc_tpu.ops import pallas_chain as jpc
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models.blocks import subnet
from selfc_tpu_torch.models.coupling import InvBlockExp
from selfc_tpu_torch.models.factory import define_G
from selfc_tpu_torch.models.inv_nets import SelfCNetCodec, SelfCNetGMM
from selfc_tpu_torch.ops import chain_variants as cv
from selfc_tpu_torch.ops import dense_chain as dc
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


def _rel_l2(got, want):
    num = sum(np.sum((got[k] - v) ** 2) for k, v in want.items())
    return float(np.sqrt(num / sum(np.sum(v ** 2) for v in want.values())))


def _rel_max(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the packing helpers
# ---------------------------------------------------------------------------


def test_pick_pack_w_matches_jax():
    for B in (1, 2, 3, 4, 6, 8, 12, 16, 24):
        for W in (8, 16, 20, 24, 32, 36, 40, 48, 64, 72, 80, 96, 112, 128, 144, 176, 192):
            assert dc.pick_pack_w(B, W) == jpc._pick_pack_w(B, W), (B, W)
    # the 4x training latent, the codec's, a serving latent, a 16-wide one
    assert [dc.pick_pack_w(B, W) for B, W in ((8, 36), (12, 72), (1, 176), (4, 16))] == [4, 2, 1, 4]


@pytest.mark.parametrize("P", [2, 4])
def test_pack_and_unpack_match_jax(P):
    x = np.random.default_rng(P).normal(0, 1, (4, 2, 3, 5, 6)).astype(np.float32)
    packed = dc.pack_w(torch.from_numpy(x), P)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpc._pack_w(jnp.asarray(x), P)))
    assert packed.is_contiguous() and packed.shape == (4 // P, 2, 3, 5 * P, 6)
    np.testing.assert_array_equal(dc.unpack_w(packed, P).numpy(), x)
    np.testing.assert_array_equal(np.asarray(jpc._unpack_w(jnp.asarray(packed.numpy()), P)), x)


# ---------------------------------------------------------------------------
# the striped chain, B3 and B2 against the JAX kernels with stripe_w
# ---------------------------------------------------------------------------

# test_pallas_chain.py::test_w_packing_matches_unpacked's shape: 4 images of
# 36 columns, packed to one row of 144
B, T, H, W, P = 4, 2, 12, 36, 4


@pytest.fixture(scope="module")
def chain():
    rng = np.random.default_rng(11)
    f = lambda s, sd: rng.normal(0, sd, s).astype(np.float32)  # noqa: E731
    C, c_out = 3, 48
    ws = [f((3, 3, C + 32 * k, 32), (9 * (C + 32 * k)) ** -0.5) for k in range(4)]
    bs = [f((32,), 0.1) for _ in range(4)]
    w5, b5 = f((3, C + 128, c_out), (3 * (C + 128)) ** -0.5), f((c_out,), 0.1)
    x, a = f((B, T, H, W, C), 0.5), f((B, T, H, W, c_out), 0.5)
    m = (rng.random((B, T, H, W, c_out)) + 0.5).astype(np.float32)
    g = f((B // P, T, H, P * W, 128), 1.0)
    pk = lambda v: np.array(jpc._pack_w(jnp.asarray(v), P))  # noqa: E731
    return {"ws": ws, "bs": bs, "w5": w5, "b5": b5, "x": pk(x), "a": pk(a), "m": pk(m), "g": g}


def _t(v):
    return [torch.from_numpy(u) for u in v] if isinstance(v, list) else torch.from_numpy(v)


def _j(v):
    return tuple(jnp.asarray(u) for u in v) if isinstance(v, list) else jnp.asarray(v)


def test_striped_chain_matches_pallas_every_epilogue(chain):
    """The port's chain on a packed input under stripe 36 against
    ``_pallas_impl_v2(..., stripe_w=36)`` interpreted, each epilogue, and
    against the unpacked chain."""
    c = chain
    for mode, n_aux in dc.EP_AUX.items():
        aux = {"a": c["a"], "m": c["m"]}
        a, m = (aux[k] if i < n_aux else None for i, k in enumerate("am"))
        want = jpc._pallas_impl_v2(_j(c["x"]), _j(c["ws"]), _j(c["bs"]), _j(c["w5"]), _j(c["b5"]), ep=mode,
                                   clamp=0.8, a=None if a is None else _j(a), m=None if m is None else _j(m),
                                   stripe_w=W)
        opt = lambda v: None if v is None else _t(v)  # noqa: E731
        with torch.no_grad():
            got = dc.dense_chain_t_ep(_t(c["x"]), _t(c["ws"]), _t(c["bs"]), _t(c["w5"]), _t(c["b5"]),
                                      mode, 0.8, opt(a), opt(m), stripe=W)
            unpacked = dc.dense_chain_t_ep_plain(
                dc.unpack_w(_t(c["x"]), P), _t(c["ws"]), _t(c["bs"]), _t(c["w5"]), _t(c["b5"]), mode, 0.8,
                *(None if v is None else dc.unpack_w(_t(v), P) for v in (a, m)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, err_msg=mode)
        np.testing.assert_allclose(dc.unpack_w(got, P).numpy(), unpacked.numpy(), atol=2e-5, err_msg=mode)


def test_striped_feats_and_adjoint_match_pallas(chain):
    """B3's features and B2's adjoint under stripe 36 against
    ``_pallas_feats`` / ``_pallas_bwd`` with ``stripe_w`` interpreted."""
    c = chain
    x, ws, bs = _t(c["x"]), _t(c["ws"]), _t(c["bs"])
    feats = dc.chain_feats(x, ws, bs, stripe_w=W)
    want_f = jpc._pallas_feats(_j(c["x"]), _j(c["ws"]), _j(c["bs"]), stripe_w=W)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_f), atol=2e-5)
    dx, dws, dbs = dc.chain_spatial_bwd(x, ws, bs, feats, _t(c["g"]), stripe_w=W)
    want = jpc._pallas_bwd(_j(c["x"]), _j(c["ws"]), _j(c["bs"]), _j(c["g"]), stripe_w=W)
    assert _rel_max(dx.numpy(), want[0]) <= 1e-4
    for u, v in zip([*dws, *dbs], jax.tree.leaves((want[1], want[2]))):
        assert _rel_max(u.numpy(), v) <= 1e-4


def test_packed_call_gradient_matches_unpacked(chain):
    """A call that packs itself (``pack=True``): the same output and, through
    the unpacking autograd, the same gradients as the unpacked call."""
    c = chain
    x = dc.unpack_w(_t(c["x"]), P)
    a, m = dc.unpack_w(_t(c["a"]), P), dc.unpack_w(_t(c["m"]), P)
    outs = []
    for pack in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (x, *_t(c["ws"]), _t(c["w5"]), a, m)]
        y = dc.dense_chain_t_ep(leaves[0], leaves[1:5], _t(c["bs"]), leaves[5], _t(c["b5"]), "sub_mul", 0.8,
                                leaves[6], leaves[7], pack=pack)
        outs.append((y.detach(), torch.autograd.grad((y * y).sum(), leaves)))
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(), atol=2e-5)
    for u, v in zip(outs[0][1], outs[1][1]):
        assert _rel_max(u.numpy(), v.numpy()) <= 1e-4


def test_stripe_must_divide_w(chain):
    c = chain
    with pytest.raises(ValueError, match="stripe_w"):
        dc.chain_feats(_t(c["x"]), _t(c["ws"]), _t(c["bs"]), stripe_w=40)


# ---------------------------------------------------------------------------
# the route where packing meets the variants, and the coupling's refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variants,mode,c_out,stripe,P,want", [
    # under a stripe only B1 (with its masks) runs
    ((), "add", 3, 36, 1, "v2"), (("ride",), "add", 3, 36, 1, "v2"), (("ride", "v3"), "none", 10, 36, 1, "v2"),
    # outside one: v3, then the ride, then the packed B1, then B1
    ((), "none", 64, 0, 4, "pack"), ((), "add", 48, 0, 4, "pack"), ((), "add", 48, 0, 1, "v2"),
    (("v3",), "none", 64, 0, 4, "v3"), (("ride",), "none", 64, 0, 4, "pack"),
    (("hg", "ride"), "add", 3, 0, 4, "ride"), (("ride",), "sig_exp", 48, 0, 4, "pack")])
def test_route_under_stripes_and_packing(variants, mode, c_out, stripe, P, want):
    """``pick`` keeps the JAX precedence (``_fused_chain_ep.prim``,
    ``_impl_best``) without the TPU's W gates: at W = 36 the F chain with
    "hg" and "ride" rides in the port where the JAX package packs."""
    assert cv.pick(frozenset(variants), mode, c_out, stripe, P) == want


def test_coupling_refuses_unmasked_routes_under_a_stripe():
    x1, x2 = torch.zeros(1, 2, 4, 8, 3), torch.zeros(1, 2, 4, 8, 48)
    plain = InvBlockExp(51, 3, subnet("D2DLTInput", "xavier"))
    with pytest.raises(RuntimeError, match="plain branch"):
        plain((x1, x2), False, 4)
    hg = InvBlockExp(51, 3, subnet("D2DTNet", "xavier"))
    hg.variants = frozenset({"hg"})
    with pytest.raises(RuntimeError, match="H/G pair"):
        hg((x1, x2), True, 4)


# ---------------------------------------------------------------------------
# the nets: the coupling chain packed once
# ---------------------------------------------------------------------------


@pytest.fixture
def chain_calls(monkeypatch):
    """Every ``dense_chain_t_ep`` call the blocks make: (C, stripe, pack)."""
    calls = []
    real = dc.dense_chain_t_ep

    def spy(x, *a, stripe=0, pack=False, **kw):
        calls.append((x.shape[-1], stripe, pack and dc.pick_pack_w(x.shape[0], x.shape[3]) > 1))
        return real(x, *a, stripe=stripe, pack=pack, **kw)

    monkeypatch.setattr(dc, "dense_chain_t_ep", spy)
    return calls


NETS = {
    # the 4x net, one block each way, the prior's two head chains: latent
    # 16x16 at batch 4, so P = 4 (tests/test_packed_chain.py's shape)
    "gmm": (lambda: JSelfCNetGMM(scale=4, block_num=(1, 1), stp_blk_num=2),
            lambda **kw: SelfCNetGMM(scale=4, block_num=(1, 1), stp_blk_num=2, device="cpu", **kw),
            (4, 3, 64, 64, 3), 48, 4),
    # the codec net, one coupling block, its growth-12 prior: latent 16x16
    # at batch 4, P = 4
    "codec": (lambda: JSelfCNetCodec(scale=2, block_num=(1,), stp_blk_num=2),
              lambda **kw: SelfCNetCodec(scale=2, block_num=(1,), stp_blk_num=2, device="cpu", **kw),
              (4, 3, 32, 32, 3), 12, 2),
}


@pytest.fixture(scope="module", params=sorted(NETS))
def net_pair(request):
    jctor, tctor, shape, hf_dim, s = NETS[request.param]
    x = np.random.default_rng(30).random(shape, dtype=np.float32)
    jm = jctor()
    tree = jax.tree.map(np.asarray, seeded_tree(jm, 31, jnp.asarray(x), method=jm.roundtrip))
    tm = tctor()
    load_jax_params(tm, tree)
    lat = shape[:2] + (shape[2] // s, shape[3] // s)
    assert dc.pick_pack_w(lat[0], lat[3]) == 4
    return jm, tm, tree, x, hf_dim, lat


def test_packed_net_matches_jax(request, net_pair, chain_calls):
    """The port packed against the JAX net: encode (the latent and the
    log-jacobian, whose sum is divided by P), decode_with_hf and, for the 4x
    net, the gradient of the whole tree of a loss over encode's latent and
    log-jacobian (relative l2). Every coupling chain ran under the stripe,
    each of the prior's chains packed its own call."""
    jm, tm, tree, x, hf_dim, lat = net_pair
    with_grad = "gmm" in request.node.callspec.id
    lr = np.round(np.random.default_rng(32).random(lat + (3,)) * 255).astype(np.float32) / 255
    hf = np.random.default_rng(33).normal(0, 0.5, lat + (hf_dim,)).astype(np.float32)
    r = np.random.default_rng(34).normal(0, 1, lat + (3 + hf_dim,)).astype(np.float32)

    def jloss(t, v):
        y, jac = jm.apply({"params": t}, v, method=jm.encode)
        return jnp.mean(y * r) + 1e-3 * jac, (y, jac)

    def jref(t, v, a, h):  # one program: its compile is most of this test's time
        (_, (y, jac)), g = jax.value_and_grad(jloss, has_aux=True)(t, v) if with_grad else (
            (None, jloss(t, v)[1]), None)
        return y, jac, jm.apply({"params": t}, a, h, method=jm.decode_with_hf)[0], g

    want, want_jac, want_hr, want_g = jax.jit(jref)(tree, jnp.asarray(x), jnp.asarray(lr), jnp.asarray(hf))
    tm.zero_grad()
    with torch.set_grad_enabled(with_grad):
        got, jac = tm.encode(torch.from_numpy(x))
        if with_grad:
            (torch.mean(got * torch.from_numpy(r)) + 1e-3 * jac).backward()
    with torch.no_grad():
        hr, _ = tm.decode_with_hf(torch.from_numpy(lr), torch.from_numpy(hf))
        tm.prior_params(torch.from_numpy(lr))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(jac.item(), float(want_jac), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(hr.numpy(), np.asarray(want_hr), atol=1e-4)
    if with_grad:
        want_g = {k: np.asarray(v) for k, v in flatten_tree(want_g).items()}
        got_g = flatten_tree(export_jax_grads(tm))
        # the prior is not in this loss
        assert _rel_l2({k: got_g[k] for k in want_g if "stp_net" not in k},
                       {k: v for k, v in want_g.items() if "stp_net" not in k}) <= 1e-4
    striped = [c for c in chain_calls if c[1]]
    assert all(s == lat[3] and not p for _, s, p in striped) and len(striped) == 6 * tm.n_blocks
    assert [c for c in chain_calls if not c[1]] == [(3, 0, True), (tm.stp_net.local_m2.chain.conv1.weight.shape[2], 0, True)]


def test_pack_w_false_and_hg_keep_the_chain_unpacked(chain_calls):
    """``network_G.pack_w: false`` reaches every chain; with it (or with
    "hg", whose pair has no masks) no chain runs under a stripe."""
    net = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1, 1], "scale": 4, "stp_blk_num": 2,
           "pack_w": False}
    g = define_G(dict_to_nonedict({"model": "SelfC_GMM", "scale": 4, "network_G": net}), device="cpu")
    assert not g.pack_w and not g.inv_blocks_0.F.chain.pack_w and not g.stp_net.local_m1.chain.pack_w
    x = torch.from_numpy(np.random.default_rng(36).random((4, 3, 64, 64, 3), dtype=np.float32))
    with torch.no_grad():
        g.encode(x)
        assert chain_calls and all(s == 0 and not p for _, s, p in chain_calls)
        g.set_pack_w(True)
        g.set_chain_variants(["hg"])
        chain_calls.clear()
        g.encode(x)
    assert g.inv_blocks_0.F.chain.pack_w and all(s == 0 for _, s, _ in chain_calls)
    codec = {**net, "block_num": [1]}
    del codec["pack_w"]
    c = define_G(dict_to_nonedict({"model": "SelfC_GMM_Codec", "scale": 2, "network_G": codec}), device="cpu")
    assert c.pack_w and c.stp_net.local_m1.chain.pack_w
