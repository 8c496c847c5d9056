"""How the port picks a chain schedule (``selfc_tpu_torch/ops/chain_variants.py``:
``pick`` against the JAX package's order, ``parse_variants``, ``define_G``'s
``chain_variants``, B7's cost model), and the ride's and v3's routes (their
gradients through the recompute route, the ride's refusal of wide outputs),
on the CPU (the kernels' plain versions and the nets against JAX are in
test_torch_chain_variants.py)."""

import numpy as np
import pytest
import torch

from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models.factory import define_G
from selfc_tpu_torch.ops import chain_variants as cv
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.utils.bench import chain_cost, hg_cost


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(rng, C, c_out):
    """Numpy chain parameters as tests/test_pallas_chain.py makes them
    (growth 32): (ws, bs, w5, b5)."""
    ws = [rng.normal(0, 0.1, (3, 3, C + 32 * i, 32)).astype(np.float32) for i in range(4)]
    bs = [rng.normal(0, 0.1, (32,)).astype(np.float32) for _ in range(4)]
    return (ws, bs, rng.normal(0, 0.1, (3, C + 128, c_out)).astype(np.float32),
            rng.normal(0, 0.1, (c_out,)).astype(np.float32))


def _t(p, grad=False):
    ws, bs, w5, b5 = p
    mk = lambda a: torch.from_numpy(a).requires_grad_(grad)  # noqa: E731
    return [mk(w) for w in ws], [mk(b) for b in bs], mk(w5), mk(b5)


def test_ride_and_v3_gradients_take_the_recompute_route():
    """A chain that took B8 or B9 keeps no features: its gradient is the
    save_feats=False route of dense_chain_t_ep, the same bits as B1's."""
    rng = np.random.default_rng(9)
    p = _chain(rng, 5, 3)
    x = rng.normal(0, 1, (1, 3, 6, 7, 5)).astype(np.float32)
    a = rng.normal(0, 1, (1, 3, 6, 7, 3)).astype(np.float32)
    grads = {}
    for name, fn in (("ride", lambda x, *q: cv.dense_chain_ride(x, *q, "add", 1.0, torch.from_numpy(a))),
                     ("v2", lambda x, *q: dc.dense_chain_t_ep(x, *q, "add", 1.0, torch.from_numpy(a))),
                     ("v3", lambda x, *q: cv.dense_chain_v3(x, *q) + torch.from_numpy(a)),
                     ("v2_none", lambda x, *q: dc.dense_chain_t_ep(x, *q) + torch.from_numpy(a))):
        xt, q = torch.from_numpy(x).requires_grad_(True), _t(p, True)
        fn(xt, *q).pow(2).sum().backward()
        grads[name] = [xt.grad, *(t.grad for t in [*q[0], *q[1], q[2], q[3]])]
    for u, v in zip(grads["ride"], grads["v2"]):
        assert torch.equal(u, v)
    for u, v in zip(grads["v3"], grads["v2_none"]):
        assert torch.equal(u, v)


def test_ride_refuses_wide_outputs():
    rng = np.random.default_rng(10)
    p = _chain(rng, 3, 12)
    with pytest.raises(ValueError, match="rides"):
        cv.dense_chain_ride(torch.zeros(1, 1, 4, 4, 3), *_t(p))


@pytest.mark.parametrize("variants,mode,c_out,want", [
    ((), "add", 3, "v2"), ((), "none", 64, "v2"),
    (("ride",), "add", 3, "ride"), (("ride",), "sig_exp", 48, "v2"), (("ride",), "none", 10, "ride"),
    (("ride",), "none", 64, "v2"), (("v3",), "add", 3, "v2"), (("v3",), "none", 3, "v3"),
    (("hg", "ride", "v3"), "none", 3, "v3"), (("hg", "ride", "v3"), "sub_from", 3, "ride"),
    (("hg",), "none", 64, "v2")])
def test_pick_follows_the_jax_order(variants, mode, c_out, want):
    """An epilogue chain rides at c_out <= 10 (``_fused_chain_ep.prim``); a
    chain without one takes v3, then the ride, then B1 (``_impl_best``)."""
    assert cv.pick(frozenset(variants), mode, c_out) == want


def test_parse_variants_rejects_unknown_names():
    assert cv.parse_variants(None) == frozenset() and cv.parse_variants(["v3", "hg"]) == {"v3", "hg"}
    for bad in (["hg", "stripe_w"], "hg"):
        with pytest.raises(ValueError, match="chain_variants"):
            cv.parse_variants(bad)


def test_define_g_takes_and_checks_chain_variants():
    net = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1, 1], "scale": 4,
           "stp_blk_num": 2, "chain_variants": ["hg", "ride", "v3"]}
    g = define_G(dict_to_nonedict({"model": "SelfC_GMM", "scale": 4, "network_G": net}), device="cpu")
    assert g.chain_variants == {"hg", "ride", "v3"}
    assert g.inv_blocks_0.variants == g.inv_blocks_0.F.chain.variants == g.stp_net.local_m2.chain.variants
    codec = {**net, "block_num": [1], "deart_net": True, "chain_variants": ["v3"]}
    c = define_G(dict_to_nonedict({"model": "SelfC_GMM_Codec", "scale": 2, "network_G": codec}), device="cpu")
    assert c.deart_0.chain.variants == {"v3"} and c.inv_blocks_0.variants == {"v3"}
    with pytest.raises(ValueError, match="unknown"):
        define_G(dict_to_nonedict({"model": "SelfC_GMM", "scale": 4,
                                   "network_G": {**net, "chain_variants": ["hg", "fast"]}}), device="cpu")


def test_hg_cost_is_two_chains_and_the_combine():
    ops, nbytes = hg_cost(1, 7, 144, 176, 3, 48, 4)
    c_ops, _ = chain_cost(1, 7, 144, 176, 3, 48, 0, 4)
    px = 7 * 144 * 176
    assert ops == 2 * c_ops + 8.0 * px * 48
    assert nbytes > 4 * px * (3 + 3 * 48)
