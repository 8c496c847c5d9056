"""The opt-in chain schedules of the port (``selfc_tpu_torch/ops/
chain_variants.py``: the H/G pair B7, the ride B9, v3 B8) against the JAX
package's Pallas kernels, run interpreted as ``tests/test_pallas_chain.py``
runs them, and the nets with ``chain_variants: [hg, ride, v3]`` against the
JAX nets with ``SELFC_TPU_PALLAS_HG`` / ``_RIDE`` / ``_V3`` set.

On the CPU the port's wrappers take their plain versions (the kernels run on
the card only), so this holds the plain versions and B7's hand-written
backward route (the selection, and the ride's and v3's routes:
test_torch_chain_route.py).

Tolerances are the JAX tests': the pair's y2 2e-4 and se 2e-5 abs, one chain
2e-5 abs, scaled by max |ref| where that exceeds 1 (``_close``: at the F
chain's shape the outputs reach 27, and fp32 sums of that size taken in
oneDNN's order and in XLA's differ by more than 2e-5); a block 3e-5; a net
1e-4 abs (chains, exp and products compound) and its whole gradient 1e-4 in
relative l2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.models.blocks import subnet as jsubnet
from selfc_tpu.models.coupling import InvBlockExp as JInvBlockExp
from selfc_tpu.models.inv_nets import SelfCNetCodec as JSelfCNetCodec
from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
from selfc_tpu.ops import pallas_chain as jpc
from selfc_tpu_torch.models.blocks import subnet
from selfc_tpu_torch.models.coupling import InvBlockExp
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


@pytest.fixture
def jax_variants(monkeypatch):
    """The JAX package with its kernels forced on (interpreted on the CPU)
    and all three variants opted in."""
    for flag in ("SELFC_TPU_PALLAS", "SELFC_TPU_PALLAS_HG", "SELFC_TPU_PALLAS_RIDE", "SELFC_TPU_PALLAS_V3"):
        monkeypatch.setenv(flag, "1")


def _chain(rng, C, c_out):
    """Numpy chain parameters as tests/test_pallas_chain.py makes them
    (growth 32): (ws, bs, w5, b5)."""
    ws = [rng.normal(0, 0.1, (3, 3, C + 32 * i, 32)).astype(np.float32) for i in range(4)]
    bs = [rng.normal(0, 0.1, (32,)).astype(np.float32) for _ in range(4)]
    return (ws, bs, rng.normal(0, 0.1, (3, C + 128, c_out)).astype(np.float32),
            rng.normal(0, 0.1, (c_out,)).astype(np.float32))


def _j(p):
    ws, bs, w5, b5 = p
    return tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), jnp.asarray(w5), jnp.asarray(b5)


def _close(got, want, atol=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * max(1.0, float(np.abs(want).max())))


def _t(p, grad=False):
    ws, bs, w5, b5 = p
    mk = lambda a: torch.from_numpy(a).requires_grad_(grad)  # noqa: E731
    return [mk(w) for w in ws], [mk(b) for b in bs], mk(w5), mk(b5)


# ---------------------------------------------------------------------------
# B7: the H/G pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("shape,c_out", [((1, 3, 24, 32, 3), 48), ((2, 2, 12, 20, 3), 12)])
def test_hg_pair_matches_pallas(shape, c_out, rev):
    """The shapes of test_hg_kernel_matches_oracle: the 4x pair, and the
    codec's c_out with a W the TPU kernel pads."""
    rng = np.random.default_rng(11)
    h, g = _chain(rng, shape[-1], c_out), _chain(rng, shape[-1], c_out)
    x = rng.normal(0, 1, shape).astype(np.float32)
    x2 = rng.normal(0, 1, shape[:-1] + (c_out,)).astype(np.float32)
    want_y2, want_se = jpc._pallas_impl_hg(jnp.asarray(x), jnp.asarray(x2), *_j(h), *_j(g), 1.0, rev)
    dc.reset_launch_counts()
    cv.reset_launch_counts()
    with torch.no_grad():
        y2, se = cv.fused_hg_pair(torch.from_numpy(x), torch.from_numpy(x2), *_t(h), *_t(g), 1.0, rev)
    np.testing.assert_allclose(y2.numpy(), np.asarray(want_y2), atol=2e-4)
    np.testing.assert_allclose(se.numpy(), np.asarray(want_se), atol=2e-5)
    assert cv.launches_hg == 0 and dc.launches == 0   # a CPU tensor takes the plain version


@pytest.mark.parametrize("rev", [False, True])
def test_hg_pair_gradient_matches_jax(rev):
    """B7's backward route (features recomputed, the combine's and conv5's
    adjoints as glue, the chain adjoint once a chain) against jax.grad of
    _xla_hg, as test_hg_grads_match_oracle: a loss through y2 and log(se)."""
    rng = np.random.default_rng(12)
    h, g = _chain(rng, 3, 12), _chain(rng, 3, 12)
    x = rng.normal(0, 1, (1, 2, 8, 16, 3)).astype(np.float32)
    x2 = rng.normal(0, 1, (1, 2, 8, 16, 12)).astype(np.float32)

    def jloss(x, x2, h, g):
        y2, se = jpc._xla_hg(x, x2, *h, *g, 1.0, rev)
        return jnp.sum(y2 ** 2) + jnp.sum(jnp.log(se))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(jnp.asarray(x), jnp.asarray(x2), _j(h), _j(g))
    xt, x2t = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(x2).requires_grad_(True)
    th, tg = _t(h, True), _t(g, True)
    y2, se = cv.fused_hg_pair(xt, x2t, *th, *tg, 1.0, rev)
    (torch.sum(y2 ** 2) + torch.sum(torch.log(se))).backward()
    leaves = lambda p: [*p[0], *p[1], p[2], p[3]]  # noqa: E731
    got = [xt.grad, x2t.grad, *(t.grad for t in leaves(th) + leaves(tg))]
    for u, v in zip(got, jax.tree.leaves(want)):
        v = np.asarray(v)
        np.testing.assert_allclose(u.numpy(), v, rtol=0, atol=1e-5 * max(1.0, np.abs(v).max()))


def test_hg_pair_plain_is_the_two_chains_and_the_combine():
    """The pair's plain version against B1's plain chains and the combine
    written out, at growth 12 (the widths B1 takes)."""
    rng = np.random.default_rng(14)
    mk = lambda *s: torch.from_numpy(rng.normal(0, 0.3, s).astype(np.float32))  # noqa: E731
    x, x2 = mk(2, 3, 5, 7, 4), mk(2, 3, 5, 7, 6)
    h = ([mk(3, 3, 4 + 12 * k, 12) for k in range(4)], [mk(12) for _ in range(4)], mk(3, 52, 6), mk(6))
    g = ([mk(3, 3, 4 + 12 * k, 12) for k in range(4)], [mk(12) for _ in range(4)], mk(3, 52, 6), mk(6))
    for rev in (False, True):
        y2, se = cv.fused_hg_pair_plain(x, x2, *h, *g, 0.7, rev)
        h5, g5 = dc.dense_chain_t_ep_plain(x, *h), dc.dense_chain_t_ep_plain(x, *g)
        want_se = torch.exp((-0.7 if rev else 0.7) * (2 * torch.sigmoid(h5) - 1))
        want_y2 = (x2 - g5) * want_se if rev else x2 * want_se + g5
        torch.testing.assert_close(se, want_se, atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(y2, want_y2, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# B9: the ride, B8: v3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,c_out", [((1, 7, 24, 32, 48), 3), ((2, 3, 24, 32, 3), 6),
                                         ((1, 1, 12, 16, 64), 10), ((1, 2, 48, 32, 51), 3)])
def test_ride_matches_pallas(shape, c_out):
    """test_ride_kernel_matches_xla's shapes: the F chain's family, c_out 6
    and 10, T 1, a multi-tile H with an unaligned C."""
    rng = np.random.default_rng(7)
    p = _chain(rng, shape[-1], c_out)
    x = rng.normal(0, 1, shape).astype(np.float32)
    want = jpc._pallas_impl_v2r(jnp.asarray(x), *_j(p))
    with torch.no_grad():
        got = cv.dense_chain_ride(torch.from_numpy(x), *_t(p))
    _close(got.numpy(), want)


def test_ride_with_epilogue_matches_pallas():
    rng = np.random.default_rng(8)
    shape, c_out = (1, 4, 24, 32, 48), 3
    p = _chain(rng, shape[-1], c_out)
    x = rng.normal(0, 1, shape).astype(np.float32)
    a = rng.normal(0, 1, shape[:-1] + (c_out,)).astype(np.float32)
    want = jpc._pallas_impl_v2r(jnp.asarray(x), *_j(p), ep="add", a=jnp.asarray(a))
    with torch.no_grad():
        got = cv.dense_chain_ride(torch.from_numpy(x), *_t(p), "add", 1.0, torch.from_numpy(a))
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape,c_out", [((1, 7, 24, 32, 3), 48), ((2, 3, 24, 32, 48), 3),
                                         ((1, 1, 12, 16, 64), 64), ((1, 2, 12, 16, 51), 12),
                                         ((1, 2, 48, 32, 3), 48)])
def test_v3_matches_pallas(shape, c_out):
    """test_v3_kernel_matches_xla's shapes: pack depths 2 and 4, T 1, an
    unaligned C, a multi-tile H."""
    rng = np.random.default_rng(0)
    p = _chain(rng, shape[-1], c_out)
    x = rng.normal(0, 1, shape).astype(np.float32)
    want = jpc._pallas_impl_v3(jnp.asarray(x), *_j(p))
    with torch.no_grad():
        got = cv.dense_chain_v3(torch.from_numpy(x), *_t(p))
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# a coupling block and the nets
# ---------------------------------------------------------------------------


def test_coupling_hg_matches_jax(jax_variants):
    """test_coupling_hg_off_matches_on's block: the JAX InvBlockExp on its
    pair kernel against the port's block with variants {hg}: forward,
    reverse, both log-jacobians, and the inverse."""
    rng = np.random.default_rng(13)
    x = (rng.normal(0, 0.5, (1, 2, 12, 16, 51))).astype(np.float32)
    jblk = JInvBlockExp(51, 3, jsubnet("D2DTNet", "xavier"))
    tree = jax.tree.map(np.asarray, seeded_tree(jblk, 3, jnp.asarray(x)))
    blk = InvBlockExp(51, 3, subnet("D2DTNet", "xavier"))
    load_jax_params(blk, tree)
    blk.variants = frozenset({"hg"})
    y, jac = jblk.apply({"params": tree}, jnp.asarray(x), False)
    xr, jac_r = jblk.apply({"params": tree}, y, True)
    with torch.no_grad():
        (y1, y2), tjac = blk((torch.from_numpy(x[..., :3].copy()), torch.from_numpy(x[..., 3:].copy())))
        (r1, r2), tjac_r = blk((y1, y2), rev=True)
    np.testing.assert_allclose(torch.cat([y1, y2], -1).numpy(), np.asarray(y), atol=3e-5)
    np.testing.assert_allclose(torch.cat([r1, r2], -1).numpy(), np.asarray(xr), atol=3e-5)
    np.testing.assert_allclose(torch.cat([r1, r2], -1).numpy(), x, atol=1e-4)
    np.testing.assert_allclose([tjac.item(), tjac_r.item()], [float(jac), float(jac_r)], rtol=1e-4, atol=1e-4)


def _rel_l2(got, want):
    num = sum(np.sum((got[k] - v) ** 2) for k, v in want.items())
    return float(np.sqrt(num / sum(np.sum(v ** 2) for v in want.values())))


NETS = {
    # the 4x net cut to one block each way and the prior's two head chains;
    # latents 8 x 16 (the JAX ride and v3 gates want W % 16 == 0)
    "gmm": (lambda **kw: JSelfCNetGMM(scale=4, block_num=(1, 1), stp_blk_num=1, **kw),
            lambda **kw: SelfCNetGMM(scale=4, block_num=(1, 1), stp_blk_num=1, device="cpu", **kw),
            (1, 3, 32, 64, 3), 48),
    # the codec net with one coupling block (F 12->3 rides, H/G 3->12 pair,
    # the prior's growth-12 chains take v3)
    "codec": (lambda **kw: JSelfCNetCodec(scale=2, block_num=(1,), stp_blk_num=2, **kw),
              lambda **kw: SelfCNetCodec(scale=2, block_num=(1,), stp_blk_num=2, device="cpu", **kw),
              (1, 3, 16, 32, 3), 12),
}


@pytest.fixture(scope="module", params=sorted(NETS))
def net_pair(request):
    jctor, tctor, shape, hf_dim = NETS[request.param]
    x = np.random.default_rng(20).random(shape, dtype=np.float32)
    jm = jctor()
    tree = jax.tree.map(np.asarray, seeded_tree(jm, 21, jnp.asarray(x), method=jm.roundtrip))
    tm = tctor(chain_variants=["hg", "ride", "v3"])
    load_jax_params(tm, tree)
    return jm, tm, tree, x, hf_dim


def test_net_with_variants_matches_jax(net_pair, jax_variants):
    """encode and decode_with_hf, the JAX net on its three variant kernels
    (interpreted), the port's on their plain versions."""
    jm, tm, tree, x, hf_dim = net_pair
    want, want_jac = jax.jit(lambda t, v: jm.apply({"params": t}, v, method=jm.encode))(tree, jnp.asarray(x))
    lat = want.shape[:-1]
    lr = np.round(np.random.default_rng(22).random(lat + (3,)) * 255).astype(np.float32) / 255
    hf = np.random.default_rng(23).normal(0, 0.5, lat + (hf_dim,)).astype(np.float32)
    want_hr, _ = jax.jit(lambda t, a, h: jm.apply({"params": t}, a, h, method=jm.decode_with_hf))(
        tree, jnp.asarray(lr), jnp.asarray(hf))
    with torch.no_grad():
        got, jac = tm.encode(torch.from_numpy(x))
        hr, _ = tm.decode_with_hf(torch.from_numpy(lr), torch.from_numpy(hf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(jac.item(), float(want_jac), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(hr.numpy(), np.asarray(want_hr), atol=1e-4)


def test_net_with_variants_gradient_matches_jax(net_pair):
    """One gradient of the whole tree through encode and decode_with_hf: B7's
    backward route and the B8 / B9 chains' recompute route against JAX's
    autodiff of the same net on its XLA path (the forward above holds the
    variant kernels; interpreting their Pallas adjoints too would double
    this file's time), in relative l2 over the tree."""
    jm, tm, tree, x, hf_dim = net_pair
    lat = x.shape[:2] + tuple(s // (4 if hf_dim == 48 else 2) for s in x.shape[2:4])
    r = np.random.default_rng(24).normal(0, 1, lat + (3 + hf_dim,)).astype(np.float32)
    hf = np.random.default_rng(25).normal(0, 0.5, lat + (hf_dim,)).astype(np.float32)

    def jloss(t, v):
        y, _ = jm.apply({"params": t}, v, method=jm.encode)
        hr, _ = jm.apply({"params": t}, y[..., :3], jnp.asarray(hf), method=jm.decode_with_hf)
        return jnp.mean(y * r) + jnp.mean(hr ** 2)

    want_t = jax.jit(jax.grad(jloss))(tree, jnp.asarray(x))
    tm.zero_grad()
    y, _ = tm.encode(torch.from_numpy(x))
    hr, _ = tm.decode_with_hf(y[..., :3], torch.from_numpy(hf))
    (torch.mean(y * torch.from_numpy(r)) + torch.mean(hr ** 2)).backward()
    want = {k: np.asarray(v) for k, v in flatten_tree(want_t).items()}
    got = flatten_tree(export_jax_grads(tm))
    assert _rel_l2(got, want) <= 1e-4
