"""The codec's training slice of the port against the JAX package, fp32 on
the CPU: the surrogate's blocks (``DenseBlock2D``, ``FeatureCollapse``), the
surrogate nets, the mimick losses and the value swap, the host codec span,
the q stream, the codec noise, and one whole training step of a small
SelfC_GMM_Codec with its surrogate (logs, the gradient tree, the parameters
after the step) fed one shared codec output.

On the JAX side parameter shapes come from ``jax.eval_shape`` and the step
is one ``jax.jit`` of ``jax.value_and_grad``, never a flax ``init``.

Tolerances: modules 1e-5 abs (the same fp32 products summed in another
order, activations of order one); the step's logs 1e-5 relative; each
gradient leaf 1e-4 relative l2 (a leaf that is zero by construction holds
rounding noise: compared on the scale of the largest leaf); the parameters
after one Adam step 1e-5 abs (an element moves by at most lr = 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfc_tpu.codec import surrogate as jsur
from selfc_tpu.config import dict_to_nonedict as jnonedict
from selfc_tpu.models import blocks as jblocks
from selfc_tpu.models.inv_nets import SelfCNetCodec as JSelfCNetCodec
from selfc_tpu.train.codec_model import CodecModel as JCodecModel
from selfc_tpu.train.rescale_model import make_degrade as jmake_degrade
from selfc_tpu_torch.codec import surrogate as tsur
from selfc_tpu_torch.codec.noise import add_noise
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models import blocks as tblocks
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.utils.jax_import import (export_jax_grads, export_jax_params, flatten_tree,
                                              load_jax_params)
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
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


def _both(jm, tm, seed, x, *args):
    """(jax output, port output) of one module with the same seeded
    parameters on the same input."""
    tree = seeded_tree(jm, seed, jnp.asarray(x), *args)
    load_jax_params(tm, tree)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, *args))(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *args).numpy()
    return want, got


# ---------------------------------------------------------------------------
# the surrogate's blocks and nets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c_in,c_out,is_res,shape", [
    (4, 6, False, (2, 8, 12)),          # images (N,H,W,C): the reference DenseBlock
    (6, 6, True, (1, 2, 8, 12)),        # every frame of a video, residual
])
def test_dense_block_2d_matches_jax(c_in, c_out, is_res, shape):
    x = _rand(1, shape + (c_in,))
    want, got = _both(jblocks.DenseBlock2D(c_in, c_out, init_mode="plain_xavier", is_res=is_res),
                      tblocks.DenseBlock2D(c_in, c_out, init_mode="plain_xavier", is_res=is_res), 2, x)
    assert got.shape == want.shape == shape + (c_out,)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("scale,is_res", [(4, True), (2, False)])
def test_feature_collapse_matches_jax(scale, is_res):
    """Space-to-depth (block-position-major), a chain with full 3x3x3 convs
    first and last, depth-to-space (PixelShuffle order)."""
    x = _rand(3, (1, 3, 8, 8, 3))
    want, got = _both(jblocks.FeatureCollapse(3, 3, scale, 4, is_res=is_res),
                      tblocks.FeatureCollapse(3, 3, scale, 4, is_res=is_res), 4, x)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dynamic_q", [False, True])
def test_h265_surrogate_matches_jax(dynamic_q):
    """The published surrogate (hidden 24, two FeatureCollapse blocks), with
    the t indicator plane or the (t, q/30) token MLP."""
    lr = np.random.default_rng(5).random((1, 3, 8, 8, 3), dtype=np.float32)
    q = jnp.float32(21.0)
    jm, tm = jsur.H265Surrogate(dynamic_q=dynamic_q), tsur.H265Surrogate(dynamic_q)
    tree = seeded_tree(jm, 6, jnp.asarray(lr), q)
    load_jax_params(tm, tree)
    want = np.asarray(jax.jit(lambda p, v: jm.apply({"params": p}, v, q))(tree, jnp.asarray(lr)))
    with torch.no_grad():
        got = tm(torch.from_numpy(lr), 21.0).numpy()
    assert ("fuser_0" in tree) == dynamic_q
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_h265_surrogate_plain_matches_jax():
    lr = np.random.default_rng(7).random((1, 3, 8, 8, 3), dtype=np.float32)
    want, got = _both(jsur.H265SurrogatePlain(), tsur.H265SurrogatePlain(), 8, lr)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dense_chain_routes():
    """D2DT takes the whole-chain kernel's route, a growth-32 chain of
    spatial convs with another conv5 the v1 spatial chain's, FeatureCollapse's
    chain (growth 128, 3-D convs) the plain convs."""
    calls = []
    routes = {"dense_chain_t_ep": dc.dense_chain_t_ep, "fused_dense_spatial": dc.fused_dense_spatial}
    try:
        for name, fn in routes.items():
            setattr(dc, name, lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
        x = torch.from_numpy(_rand(9, (1, 3, 8, 8, 4)))
        tblocks.D2DT(4, 4)(x)
        tblocks.DenseBlock2D(4, 4)(x)
        tblocks.DenseBlock2D(4, 4, gc=12)(x)
        tblocks.FeatureCollapse(4, 4, 4)(x)
    finally:
        for name, fn in routes.items():
            setattr(dc, name, fn)
    assert calls == ["dense_chain_t_ep", "fused_dense_spatial"]


# ---------------------------------------------------------------------------
# the mimick losses, the host codec span, q, noise
# ---------------------------------------------------------------------------


def test_mimick_and_swap_value_is_codec_grad_is_surrogate():
    """As tests/test_codec.py's TestSurrogateSwap, and against the JAX
    function: the loss (MSE - lambda * Pearson), the swapped value, and the
    gradient reaching the surrogate's output."""
    sug_np, codec_np = _rand(10, (2, 3, 4, 4, 3)), _rand(11, (2, 3, 4, 4, 3))

    def jf(s):
        swapped, loss = jsur.mimick_and_swap(s, jnp.asarray(codec_np), 1e-2)
        return jnp.sum(swapped ** 2) + loss, (swapped, loss)

    (_, (j_sw, j_loss)), j_grad = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(sug_np))
    sug = torch.from_numpy(sug_np).requires_grad_(True)
    swapped, loss = tsur.mimick_and_swap(sug, torch.from_numpy(codec_np), 1e-2)
    (torch.sum(swapped ** 2) + loss).backward()
    np.testing.assert_allclose(swapped.detach().numpy(), codec_np, atol=1e-6)  # sug + (codec - sug)
    np.testing.assert_array_equal(swapped.detach().numpy(), np.asarray(j_sw))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(sug.grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-7)
    assert np.abs(sug.grad.numpy()).max() > 0


def test_mimick_plain_matches_jax():
    sug_np, codec_np = _rand(12, (1, 3, 4, 4, 3)), _rand(13, (1, 3, 4, 4, 3))
    j_out, j_loss = jsur.mimick_plain(jnp.asarray(sug_np), jnp.asarray(codec_np))
    sug = torch.from_numpy(sug_np).requires_grad_(True)
    out, loss = tsur.mimick_plain(sug, torch.from_numpy(codec_np))
    loss.backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(sug.grad.numpy(), 2 * (sug_np - codec_np) / sug_np.size, rtol=1e-5)


@pytest.mark.parametrize("stand_in", ["zlib", "null"])
def test_h265_host_roundtrip_matches_jax(monkeypatch, stand_in):
    """The stand-in on both stacks (no real x265): the same decoded clips,
    bit for bit, and the same mean bpp."""
    monkeypatch.setenv("SELFC_TPU_DISABLE_X265", "1")
    lr = np.random.default_rng(14).random((3, 3, 16, 24, 3), dtype=np.float32) * 1.2 - 0.1
    want, want_bpp = jsur.h265_host_roundtrip(lr, 16, 3, 2, stand_in=stand_in)
    got, got_bpp = tsur.h265_host_roundtrip(lr, 16, 3, 2, stand_in=stand_in)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got_bpp == want_bpp


def test_draw_q_matches_jax():
    j, t = object.__new__(JCodecModel), object.__new__(CodecModel)
    for m in (j, t):
        m._q_seed, m.q = 3, [8, 35]
    assert [t._draw_q(s) for s in range(40)] == [j._draw_q(s) for s in range(40)]


def test_add_noise_draws_from_its_generator():
    x = torch.zeros(20000)
    u = add_noise(x, torch.Generator().manual_seed(0), 1e-3, "uniform")
    assert torch.equal(u, add_noise(x, torch.Generator().manual_seed(0), 1e-3, "uniform"))
    assert 1e-4 <= u.abs().min().item() and u.abs().max().item() <= 1e-3
    assert abs((u > 0).float().mean().item() - 0.5) < 0.02
    g = add_noise(x, torch.Generator().manual_seed(1), 1e-3, "gaussian")
    assert abs(g.std().item() - 2e-3) < 1e-4
    with pytest.raises(ValueError):
        add_noise(x, torch.Generator(), 1e-3, "laplace")


# ---------------------------------------------------------------------------
# one training step of a small codec net with its surrogate
# ---------------------------------------------------------------------------

NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "in_nc": 3, "out_nc": 3, "block_num": [1],
       "scale": 2, "init": "xavier", "global_module": "nonlocal", "stp_blk_num": 1, "fh_loss": "l2",
       "h265_deart": False, "h265_q": 16, "lambda_corr": 1e-5, "stp_hidden_c": 24,
       "stp_denseblock_innerc": 12}
TRAIN = {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "lr_scheme": "MultiStepLR",
         "lr_steps": [300000], "lr_gamma": 0.5, "pixel_criterion_forw": "l2",
         "pixel_criterion_back": "l1", "noise_type": "h265", "h265_sug": True,
         "lambda_fit_forw": 1, "lambda_rec_back": 0.1, "lambda_mimick_loss": 4,
         "loss_multiplier": 1000, "gradient_clipping": 0.5}
CLIP = (2, 3, 16, 16, 3)


def _train_opt(network=None, **train):
    return dict_to_nonedict({
        "model": "SelfC_GMM_Codec", "distortion": "sr_bd", "scale": 2, "is_train": True,
        "datasets": {"train": {"video_len": 3, "batch_size": 2, "GT_size": 16}},
        "network_G": dict(NET, **(network or {})), "train": dict(TRAIN, **train)})


def _step_pair(network=None):
    """One step through both stacks from the same parameters, clip and
    codec output. JAX side: the loss of selfc_tpu/train/codec_model.py
    (``_encode_lf`` into ``_loss``, as its ``_train_step_reencode``
    composes them) under one ``jax.jit(jax.value_and_grad)``, and its
    optax chain."""
    net = dict(NET, **(network or {}))
    x = np.random.default_rng(20).random(CLIP, dtype=np.float32)
    codec_out = np.random.default_rng(21).random((2, 3, 8, 8, 3), dtype=np.float32)
    jm = object.__new__(JCodecModel)
    jm.net = JSelfCNetCodec(scale=2, block_num=(1,), stp_blk_num=1, deart_net=bool(net.get("deart_net")))
    jm.surrogate = jsur.H265Surrogate(dynamic_q=False)
    jm.train_opt, jm.net_opt = jnonedict(dict(TRAIN)), jnonedict(net)
    jm.noise_type, jm.use_surrogate, jm.surrogate_variant, jm._mp = "h265", True, "correlation1", False
    jm.degrade = jmake_degrade("sr_bd", 2)
    hr = jnp.asarray(x)
    tree = {"net": seeded_tree(jm.net, 22, hr, method=jm.net.roundtrip),
            "surrogate": seeded_tree(jm.surrogate, 23, jnp.zeros((1, 3, 8, 8, 3)), jnp.float32(16))}
    ref_l = jm.degrade(hr)

    tx = optax.chain(optax.clip_by_global_norm(TRAIN["gradient_clipping"]), optax.scale_by_adam(0.9, 0.999))

    def step(p):
        (_, logs), grads = jax.value_and_grad(
            lambda q: jm._loss(q, jm._encode_lf(q, hr), hr, ref_l, jnp.asarray(codec_out),
                               jax.random.PRNGKey(0), jnp.float32(16)), has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return logs, grads, jax.tree.map(lambda a, u: a - TRAIN["lr_G"] * u, p, updates)

    logs, grads, after = jax.jit(step)(tree)   # one program: eager optax over the tree takes ~50 s
    jax_step = {"logs": {k: float(v) for k, v in logs.items()},
                "grads": jax.tree.map(np.asarray, grads), "params": jax.tree.map(np.asarray, after)}

    model = CodecModel(_train_opt(network), device="cpu")
    model.load_jax_params(tree)
    assert model.feed_data({"GT": x}) == 3
    model.optimize_parameters(0, codec_out=codec_out)
    port_step = {"logs": dict(model.get_current_log()), "grad_norm": float(model.grad_norm),
                 "grads": export_jax_grads(model.params), "params": export_jax_params(model.params)}
    return jax_step, port_step, tree, x, codec_out


@pytest.fixture(scope="module")
def step_pair():
    return _step_pair()


@pytest.fixture(scope="module")
def step_pair_deart():
    """The same step with ``deart_net: true``: the decode runs the
    de-artifact net, whose deformable aggregation is differentiated (the
    JAX side's Pallas kernel in interpret mode, its VJP the composition's)."""
    return _step_pair({"deart_net": True})


def _assert_gradient_tree_matches(jax_step, port_step):
    """Leaf by leaf; the port's ``.grad`` is clipped in place, so its
    leaves are scaled back by norm / clip."""
    want, got = flatten_tree(jax_step["grads"]), flatten_tree(port_step["grads"])
    assert set(got) == set(want) and any(k.startswith("surrogate.") for k in want)
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in want.values()))
    np.testing.assert_allclose(port_step["grad_norm"], norm, rtol=1e-4)
    assert norm > TRAIN["gradient_clipping"]  # the clip is active in this test
    top = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        g = got[k] * (norm / TRAIN["gradient_clipping"])
        if np.abs(v).max() < 1e-6 * top:   # zero by construction: rounding noise on both sides
            assert np.abs(g - v).max() <= 1e-6 * top, k
        else:
            assert np.linalg.norm(g - v) <= 1e-4 * np.linalg.norm(v), (k, np.linalg.norm(g - v) / np.linalg.norm(v))


def test_codec_train_step_logs_match_jax(step_pair):
    jax_step, port_step = step_pair[:2]
    logs = port_step["logs"]
    assert set(logs) == set(jax_step["logs"]) | {"skipped_nonfinite", "lr", "img_bpp", "rate_source"}
    for k, want in jax_step["logs"].items():
        np.testing.assert_allclose(logs[k], want, rtol=1e-5, atol=1e-12, err_msg=k)
    assert logs["skipped_nonfinite"] == 0.0 and logs["lr"] == 1e-4 and logs["img_bpp"] == 0.0
    assert logs["mimick_loss"] > 0 and logs["distortion_loss"] > 0


def test_codec_train_step_gradient_tree_matches_jax(step_pair):
    _assert_gradient_tree_matches(*step_pair[:2])


def test_codec_deart_train_step_logs_match_jax(step_pair_deart):
    jax_step, port_step = step_pair_deart[:2]
    for k, want in jax_step["logs"].items():
        np.testing.assert_allclose(port_step["logs"][k], want, rtol=1e-5, atol=1e-12, err_msg=k)


def test_codec_deart_train_mixed_precision_keeps_fp32_masters(step_pair_deart):
    """``train.mixed_precision`` with the de-artifact net: its deformable
    convs take bf16 operands (the master parameters cast like the rest of
    the net), the step is finite and moves the de-artifact leaves, which stay
    fp32."""
    _, _, tree, x, codec_out = step_pair_deart
    model = CodecModel(_train_opt({"deart_net": True}, mixed_precision=True), device="cpu")
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, codec_out=codec_out)
    log = model.get_current_log()
    assert log["skipped_nonfinite"] == 0.0 and np.isfinite(log["loss"])
    assert model.net.deart_1.offset_w.dtype == torch.float32
    moved = flatten_tree(export_jax_params(model.params))
    for k in ("net.deart_1.offset_w", "net.deart_1.regular_w", "net.deart_0.chain.conv1.weight"):
        assert np.abs(moved[k] - flatten_tree(tree)[k]).max() > 1e-6, k


def test_codec_deart_train_step_gradient_tree_matches_jax(step_pair_deart):
    """Every leaf within 1e-4 relative l2, the de-artifact net's included:
    its deformable aggregation's offset, modulator and regular convs get
    their gradients through the op's closed-form adjoint."""
    jax_step, port_step = step_pair_deart[:2]
    deart = [k for k in flatten_tree(jax_step["grads"]) if ".deart_1." in k]
    assert {"net.deart_1.offset_w", "net.deart_1.modulator_w", "net.deart_1.regular_w"} <= set(deart)
    _assert_gradient_tree_matches(jax_step, port_step)


def test_codec_parameters_after_step_match_jax(step_pair):
    jax_step, port_step, tree = step_pair[:3]
    want, got, start = (flatten_tree(t) for t in (jax_step["params"], port_step["params"], tree))
    moved = 0
    for k, v in want.items():
        assert np.abs(got[k] - v).max() <= 1e-5, (k, np.abs(got[k] - v).max())
        moved += np.abs(got[k] - start[k]).max() > 1e-5
    assert moved >= len(want) - 2  # all but the leaves whose gradient is zero by construction


def test_codec_train_reencode_split_gives_the_same_step(step_pair):
    """``train.codec_split: reencode`` runs the encode again inside the loss:
    the same logs and the same parameters, bit for bit."""
    _, port_step, tree, x, codec_out = step_pair
    model = CodecModel(_train_opt(codec_split="reencode"), device="cpu")
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, codec_out=codec_out)
    assert dict(model.get_current_log()) == port_step["logs"]
    for k, v in flatten_tree(export_jax_params(model.params)).items():
        np.testing.assert_array_equal(v, flatten_tree(port_step["params"])[k])


def test_codec_train_nonfinite_loss_skips_the_update(step_pair):
    _, _, tree, x, codec_out = step_pair
    model = CodecModel(_train_opt(), device="cpu")
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    bad = codec_out.copy()
    bad[0, 0, 0, 0, 0] = np.nan
    model.optimize_parameters(0, codec_out=bad)
    assert model.get_current_log()["skipped_nonfinite"] == 1.0
    for k, v in flatten_tree(export_jax_params(model.params)).items():
        np.testing.assert_array_equal(v, flatten_tree(tree)[k])


def test_codec_train_through_the_host_codec(monkeypatch):
    """Without a fed codec output the step runs the quantised LR through the
    host codec (the zlib stand-in here) and logs its measured bpp and
    rate_source."""
    monkeypatch.setenv("SELFC_TPU_DISABLE_X265", "1")
    monkeypatch.delenv("SELFC_TPU_STANDIN_CODEC", raising=False)
    model = CodecModel(_train_opt(), device="cpu")
    model.feed_data({"GT": np.random.default_rng(24).random(CLIP, dtype=np.float32)})
    model.optimize_parameters(0)
    log = model.get_current_log()
    assert log["rate_source"] == "zlib" and log["img_bpp"] > 0 and log["skipped_nonfinite"] == 0.0


def test_codec_train_mixed_precision_keeps_fp32_masters(step_pair):
    """``train.mixed_precision``: bf16 activations over fp32 master
    parameters; the host codec and the 255-level rounding stay fp32; the
    step is finite and moves the parameters."""
    _, _, tree, x, codec_out = step_pair
    model = CodecModel(_train_opt(mixed_precision=True), device="cpu")
    model.load_jax_params(tree)
    model.feed_data({"GT": x})
    assert model._encode_lf(model._hr).dtype == torch.bfloat16
    model.optimize_parameters(0, codec_out=codec_out)
    log = model.get_current_log()
    assert log["skipped_nonfinite"] == 0.0 and np.isfinite(log["loss"])
    assert all(p.dtype == torch.float32 for p in model.params.parameters())
    moved = flatten_tree(export_jax_params(model.params))
    assert np.abs(moved["net.inv_blocks_0.F.chain.conv1.weight"]
                  - flatten_tree(tree)["net.inv_blocks_0.F.chain.conv1.weight"]).max() > 1e-5


@pytest.mark.parametrize("network,train,match", [
    ({}, {"codec_pipeline": True}, "A16'"),
])
def test_codec_train_unported_options_raise(network, train, match):
    with pytest.raises(NotImplementedError, match=match):
        CodecModel(_train_opt(network, **train), device="cpu")


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "serve"])
def test_codec_checkpoint_path_raises_naming_a18(monkeypatch, is_train):
    """``path.pretrain_model_G``: the codec wrapper refuses the checkpoint it
    cannot load yet (ROADMAP A18) before it builds a net or a surrogate."""
    from selfc_tpu_torch.train import codec_model

    def no_net(*args, **kwargs):
        raise AssertionError("a net was built before the checkpoint path was refused")
    monkeypatch.setattr(codec_model, "define_G", no_net)
    opt = _train_opt({"block_num": [1, 1]})
    opt["path"] = {"pretrain_model_G": "SelfC_GMM_Codec.pth"}
    opt["is_train"] = is_train
    with pytest.raises(NotImplementedError, match="A18"):
        CodecModel(opt, device="cpu")


@pytest.mark.parametrize("network,deart", [({"h265_deart": True}, False), ({"deart_net": True}, True)])
def test_codec_train_builds_the_de_artifact_net_from_deart_net(network, deart):
    """``h265_deart`` alone builds the same net as without it (the JAX
    package reads it nowhere); ``deart_net`` adds the de-artifact net, built
    for the training clips' 3 frames, and Adam holds its parameters too."""
    model = CodecModel(_train_opt(network), device="cpu")
    names = [k for k, _ in model.params.named_parameters()]
    assert any(k.startswith("net.deart_1.") for k in names) == deart
    assert model.net.deart_net == deart
    assert sum(len(g["params"]) for g in model.optimizer.param_groups) == len(names)
