"""The first slice of the port as a whole: ``SelfCNetGMM`` and the serving
half of ``RescaleModel`` against the JAX package, fp32, on the CPU.

Parity is checked on a fed ``hf`` / ``eps``, never on a seed: the two
stacks' random generators give different numbers from the same seed.

Tolerances: the latent after two coupling blocks atol 1e-4 (chains, exp and
products compound); ``hr`` after prior + sample + two inverse blocks atol
1e-4; the quantised ``lr`` exactly, except where ``lr_pre_quant * 255`` lies
within 1e-3 of a half-integer (there the last bit decides the level).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.models.inv_nets import SelfCNetGMM as JSelfCNetGMM
from selfc_tpu.ops import gmm as jgmm
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models import define_G
from selfc_tpu_torch.models.inv_nets import SelfCNetGMM
from selfc_tpu_torch.train.rescale_model import RescaleModel
from selfc_tpu_torch.utils.jax_import import load_jax_params
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(scale=4, block_num=(1, 1), stp_blk_num=2, gmm_k=5)


def _clip(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def stacks():
    """(jax module, its numpy param tree, the port's module with the same
    parameters, input clip)."""
    x = _clip(0, (1, 3, 32, 32, 3))
    jm = JSelfCNetGMM(**SMALL)
    tree = seeded_tree(jm, 1, jnp.asarray(x), method=jm.roundtrip)
    tm = SelfCNetGMM(device="cpu", **SMALL)
    load_jax_params(tm, tree)
    return jm, tree, tm.eval(), x


def _japply(jm, tree, *args, method, **kw):
    return jm.apply({"params": tree}, *args, method=method, **kw)


def test_encode_matches_jax(stacks):
    jm, tree, tm, x = stacks
    want, want_jac = _japply(jm, tree, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        got, jac = tm.encode(torch.from_numpy(x))
    assert got.shape == (1, 3, 8, 8, 51)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(jac.item(), float(want_jac), rtol=1e-4, atol=1e-3)


def test_prior_params_match_jax(stacks):
    jm, tree, tm, _ = stacks
    lr = np.round(_clip(1, (1, 3, 8, 8, 3)) * 255) / 255
    want = _japply(jm, tree, jnp.asarray(lr), method=jm.prior_params)
    with torch.no_grad():
        got = tm.prior_params(torch.from_numpy(lr))
    assert got.shape == (1, 3, 8, 8, 48 * 5 * 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_decode_with_hf_matches_jax(stacks):
    jm, tree, tm, _ = stacks
    lr = np.round(_clip(2, (1, 3, 8, 8, 3)) * 255) / 255
    hf = np.random.default_rng(3).normal(0, 0.5, (1, 3, 8, 8, 48)).astype(np.float32)
    want, want_y = _japply(jm, tree, jnp.asarray(lr), jnp.asarray(hf),
                           method=jm.decode_with_hf)
    with torch.no_grad():
        got, got_y = tm.decode_with_hf(torch.from_numpy(lr), torch.from_numpy(hf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-4)


def test_roundtrip_with_fed_eps_matches_jax(stacks, monkeypatch):
    jm, tree, tm, x = stacks
    eps = np.random.default_rng(4).normal(0, 1, tm.eps_shape((1, 3, 8, 8, 3))).astype(np.float32)
    monkeypatch.setattr(jgmm, "sample_normal", lambda rng, shape, dtype: jnp.asarray(eps))
    want = _japply(jm, tree, jnp.asarray(x), method=jm.roundtrip,
                   rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = tm.roundtrip(torch.from_numpy(x), eps=torch.from_numpy(eps))
    pre = np.asarray(want["lr_pre_quant"])
    np.testing.assert_allclose(got["lr_pre_quant"].numpy(), pre, atol=1e-4)
    safe = np.abs((np.clip(pre, 0, 1) * 255) % 1 - 0.5) > 1e-3
    assert safe.mean() > 0.95
    np.testing.assert_array_equal(got["lr"].numpy()[safe], np.asarray(want["lr"])[safe])
    # hr is compared from the JAX side's lr, so a level that flipped at an
    # unsafe position cannot hide or fake a difference in the decode
    with torch.no_grad():
        hr, _ = tm.decode(torch.tensor(np.asarray(want["lr"])), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(hr.numpy(), np.asarray(want["hr"]), atol=1e-4)
    if np.array_equal(got["lr"].numpy(), np.asarray(want["lr"])):
        np.testing.assert_allclose(got["hr"].numpy(), hr.numpy(), atol=1e-6)
    assert got["hr"].shape == x.shape and float(got["loss_c"]) == 0.0


def test_decode_needs_noise_or_generator(stacks):
    tm = stacks[2]
    lr = torch.from_numpy(_clip(5, (1, 2, 8, 8, 3)))
    with pytest.raises(ValueError):
        tm.decode(lr)
    with torch.no_grad():
        a, _ = tm.decode(lr, generator=torch.Generator().manual_seed(7))
        b, _ = tm.decode(lr, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b)


def _opt(**val):
    return dict_to_nonedict({
        "model": "SelfC_GMM", "scale": 4, "val": val,
        "network_G": {"which_model_G": {"subnet_type": "D2DTNet"},
                      "block_num": [1, 1], "stp_blk_num": 2, "gmm_k": 5},
    })


@pytest.mark.parametrize("gop_batch", [1, 2, None])
def test_rescale_model_test_equals_roundtrip_loop(stacks, gop_batch):
    """10 frames, gop 7: two groups, the second padded with its last frame;
    the same eps stream whatever ``gop_batch`` is."""
    _, tree, tm, _ = stacks
    clip = _clip(6, (1, 10, 32, 32, 3))
    val = {} if gop_batch is None else {"gop_batch": gop_batch}
    model = RescaleModel(_opt(**val), device="cpu", rng_seed=11)
    model.load_jax_params(tree)
    assert model.feed_data({"GT": clip}) == 10
    model.test(gop=7)

    gen = torch.Generator().manual_seed(11)
    x = torch.from_numpy(clip)
    hr, lr = [], []
    for idx, orig in ((list(range(7)), 7), ([7, 8, 9, 9, 9, 9, 9], 3)):
        eps = torch.randn(tm.eps_shape((1, 7, 8, 8, 3)), generator=gen)
        with torch.no_grad():
            out = tm.roundtrip(x[:, idx], eps=eps)
        hr.append(out["hr"][:, :orig])
        lr.append(out["lr"][:, :orig])
    # batching two GOPs changes the order of sums inside batched products
    np.testing.assert_allclose(model.fake_H, torch.cat(hr, 1).numpy(), atol=1e-5)
    np.testing.assert_allclose(model.forw_L, torch.cat(lr, 1).numpy(), atol=1e-7)
    vis = model.get_current_visuals()
    assert set(vis) == {"SR", "LR", "LR_ref", "GT", "forw_H"}
    assert vis["LR_ref"].shape == vis["LR"].shape
    assert vis["SR"].shape == clip.shape and vis["LR"].shape == (1, 10, 8, 8, 3)
    assert vis["forw_H"].shape == (1, 10, 8, 8, 48)
    assert model.sample_H.shape == (1, 10, 8, 8, 48)


def test_downscale_upscale_shapes_and_dtype_option(stacks):
    _, tree, _, _ = stacks
    clip = _clip(7, (1, 2, 32, 32, 3))
    model = RescaleModel(_opt(), device="cpu")
    model.load_jax_params(tree)
    lr = model.downscale(clip)
    assert lr.shape == (1, 2, 8, 8, 3)
    assert np.allclose(lr * 255, np.round(lr * 255), atol=1e-4)
    hr = model.upscale(lr)
    assert hr.shape == clip.shape and np.isfinite(hr).all()
    bf = RescaleModel(_opt(eval_dtype="bfloat16"), device="cpu")
    bf.load_jax_params(tree)
    lr_bf = bf.downscale(clip)
    assert lr_bf.dtype == np.float32 and np.abs(lr_bf - lr).max() < 0.1
    with pytest.raises(ValueError):
        RescaleModel(_opt(eval_dtype="fp8"), device="cpu").downscale(clip)


def test_load_jax_params_is_strict(stacks):
    _, tree, _, _ = stacks
    tm = SelfCNetGMM(device="cpu", **SMALL)
    missing = {k: v for k, v in tree.items() if k != "inv_blocks_1"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(tm, missing)
    extra = dict(tree, inv_blocks_9=tree["inv_blocks_0"])
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(tm, extra)
    bad = dict(tree, stp_net=dict(tree["stp_net"], tail_0={
        "weight": np.zeros((64, 127), np.float32), "bias": tree["stp_net"]["tail_0"]["bias"]}))
    with pytest.raises(ValueError, match="tail_0.weight"):
        load_jax_params(tm, bad)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        define_G(_opt())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RescaleModel(_opt())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SelfCNetGMM(**SMALL)


@pytest.mark.parametrize("model_type,item", [("SelfC", "A22"), ("IRN", "A22"),
                                             ("SelfC_GMM_Codec", "A12")])
def test_factory_names_unported_models(model_type, item):
    """SelfC_GMM_Codec is ported but for its de-artifact net: the factory
    names what is left of A12 and the item that carries it (A24)."""
    opt = _opt()
    opt["model"] = model_type
    if model_type == "SelfC_GMM_Codec":
        opt["network_G"]["h265_deart"] = True
    with pytest.raises(NotImplementedError, match=item):
        define_G(opt, device="cpu")


def test_config_parse_matches_jax_package(tmp_path, monkeypatch):
    """The port's own YAML parser reads the JAX package's shipped config to
    the same options, and the factory builds the full-width net from it."""
    from selfc_tpu import config as jconfig
    from selfc_tpu_torch import config as tconfig

    monkeypatch.chdir(tmp_path)
    yml = os.path.join(ROOT, "selfc_tpu", "configs", "test", "test_SelfC_large_vid4.yml")
    opt = tconfig.parse(yml, is_train=False)
    assert opt == jconfig.parse(yml, is_train=False)
    assert opt["val"] is None and opt["network_G"]["missing_key"] is None
    net = define_G(opt, device="cpu")
    assert net.n_blocks == 8 and net.stp_net.stp_blk_num == 6
    assert sum(p.numel() for p in net.parameters()) == 3365038


def test_port_imports_nothing_of_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import selfc_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(selfc_tpu_torch.__path__, 'selfc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'selfc_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'yaml' not in sys.modules\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr


def test_trained_checkpoint_decode_matches_jax():
    """Full depth with the trained weights of runs/400k on an 8x8 latent
    (a 32x32 crop): decode_with_hf against the JAX package. atol 2e-4:
    eight inverse blocks, each multiplying by exp(-s), compound the chains'
    summation-order differences."""
    from flax.serialization import msgpack_restore

    with open(os.path.join(ROOT, "runs", "400k", "latest_G.msgpack"), "rb") as f:
        tree = jax.tree.map(np.asarray, msgpack_restore(f.read()))
    full = dict(scale=4, block_num=(4, 4), stp_blk_num=6, gmm_k=5)
    jm = JSelfCNetGMM(**full)
    tm = SelfCNetGMM(device="cpu", **full)
    load_jax_params(tm, tree)
    lr = np.round(_clip(8, (1, 3, 8, 8, 3)) * 255) / 255
    hf = np.random.default_rng(9).normal(0, 0.3, (1, 3, 8, 8, 48)).astype(np.float32)
    want, _ = _japply(jm, tree, jnp.asarray(lr), jnp.asarray(hf), method=jm.decode_with_hf)
    with torch.no_grad():
        got, _ = tm.decode_with_hf(torch.from_numpy(lr), torch.from_numpy(hf))
        params = tm.prior_params(torch.from_numpy(lr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    want_p = _japply(jm, tree, jnp.asarray(lr), method=jm.prior_params)
    np.testing.assert_allclose(params.numpy(), np.asarray(want_p), atol=2e-4)
