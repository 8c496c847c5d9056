"""The codec's training slice of the port against the JAX package, fp32 on
the CPU: one whole training step of a small SelfC_GMM_Codec with its
surrogate (logs, the gradient tree, the parameters after the step) fed one
shared codec output, and the pipelined step (the surrogate's blocks and
nets, the mimick losses, the host codec span, q and the noise:
test_torch_codec_parts.py).

On the JAX side parameter shapes come from ``jax.eval_shape`` and the step
is one ``jax.jit`` of ``jax.value_and_grad``, never a flax ``init``.

Tolerances: the step's logs 1e-5 relative; each
gradient leaf 1e-4 relative l2 (a leaf that is zero by construction holds
rounding noise: compared on the scale of the largest leaf), the clip's
global norm 1e-6 relative. Measured (``tests/codec_step_precision.py``, on
the ``(2,3,16,80,3)`` clip of ``tests/test_torch_mesh_nets.py``, which holds
that step too): the raw gradients' worst leaf, the prior's second
``GlobalAgg``'s ``fc_w``, 9.3e-6 from JAX's in fp32 and 7.2e-7 in float64 on
both sides (the rest is the fp32 casts both stacks keep: the attention's
logits, the loss terms); the clipped step the same, since the port's clip
sums its norm in float64 on the CPU (summed in fp32 it was 8.6e-5 low, and
every clipped leaf 1e-4 off); the parameters
after one Adam step 1e-5 abs (an element moves by at most lr = 1e-4); the
pipelined step's second update (its encode side one update stale) 1e-4
relative l2 against the JAX package's (measured 1.8e-5), 1e-6 against a
reference put together from the port's own serial pieces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from selfc_tpu.codec import surrogate as jsur
from selfc_tpu.config import dict_to_nonedict as jnonedict
from selfc_tpu.models.inv_nets import SelfCNetCodec as JSelfCNetCodec
from selfc_tpu.train.codec_model import CodecModel as JCodecModel
from selfc_tpu.train.rescale_model import make_degrade as jmake_degrade
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.train.checkpoint import read_msgpack
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.train.rescale_model import clip_by_global_norm_
from selfc_tpu_torch.utils.jax_import import export_jax_grads, export_jax_params, flatten_tree
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


def _jax_codec(network=None):
    """The JAX ``CodecModel``'s loss and encode without its ``__init__``
    (no mesh, no jits): the net, the surrogate and the options they read."""
    net = dict(NET, **(network or {}))
    jm = object.__new__(JCodecModel)
    jm.net = JSelfCNetCodec(scale=2, block_num=(1,), stp_blk_num=1, deart_net=bool(net.get("deart_net")))
    jm.surrogate = jsur.H265Surrogate(dynamic_q=False)
    jm.train_opt, jm.net_opt = jnonedict(dict(TRAIN)), jnonedict(net)
    jm.noise_type, jm.use_surrogate, jm.surrogate_variant, jm._mp = "h265", True, "correlation1", False
    jm.degrade = jmake_degrade("sr_bd", 2)
    return jm


def _jax_tx():
    """The JAX model's optax chain; the step is ``p - lr * update``."""
    return optax.chain(optax.clip_by_global_norm(TRAIN["gradient_clipping"]), optax.scale_by_adam(0.9, 0.999))


def _step_pair(network=None):
    """One step through both stacks from the same parameters, clip and
    codec output. JAX side: the loss of selfc_tpu/train/codec_model.py
    (``_encode_lf`` into ``_loss``, as its ``_train_step_reencode``
    composes them) under one ``jax.jit(jax.value_and_grad)``, and its
    optax chain."""
    x = np.random.default_rng(20).random(CLIP, dtype=np.float32)
    codec_out = np.random.default_rng(21).random((2, 3, 8, 8, 3), dtype=np.float32)
    jm = _jax_codec(network)
    hr = jnp.asarray(x)
    tree = {"net": seeded_tree(jm.net, 22, hr, method=jm.net.roundtrip),
            "surrogate": seeded_tree(jm.surrogate, 23, jnp.zeros((1, 3, 8, 8, 3)), jnp.float32(16))}
    ref_l = jm.degrade(hr)
    tx = _jax_tx()

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
    np.testing.assert_allclose(port_step["grad_norm"], norm, rtol=1e-6)
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


# ---------------------------------------------------------------------------
# train.codec_pipeline: update i with its encode side one update stale
# ---------------------------------------------------------------------------


def _pipelined(tree, split, **train):
    model = CodecModel(_train_opt(codec_pipeline=True, codec_split=split, **train), device="cpu")
    model.load_jax_params(tree)
    return model


def _flat_params(model):
    return flatten_tree(export_jax_params(model.params))


@pytest.mark.parametrize("split", ["residual", "reencode"])
def test_codec_pipeline_first_update_is_the_serial_step(step_pair, split):
    """The first call queues the batch (no update, no log yet); the flush
    retires it: the serial step's logs and parameters, bit for bit."""
    _, port_step, tree, x, codec_out = step_pair
    model = _pipelined(tree, split)
    model.feed_data({"GT": x})
    model.optimize_parameters(0, codec_out=codec_out)
    assert model._pending is not None and model.get_current_log() == {}
    model.flush_pipeline()
    assert model._pending is None
    assert dict(model.get_current_log()) == port_step["logs"]
    want = flatten_tree(port_step["params"])
    for k, v in _flat_params(model).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def _second_batch():
    """The clip and codec output of the pipelined tests' second call."""
    return (np.random.default_rng(25).random(CLIP, dtype=np.float32),
            np.random.default_rng(26).random((2, 3, 8, 8, 3), dtype=np.float32))


def _two_pipelined_updates(tree, split, x, c1, x2, c2):
    """Two pipelined calls and the flush: ``(model, parameters after update 1)``."""
    pipe = _pipelined(tree, split)
    pipe.feed_data({"GT": x})
    pipe.optimize_parameters(0, codec_out=c1)
    pipe.feed_data({"GT": x2})
    pipe.optimize_parameters(1, codec_out=c2)
    p1 = _flat_params(pipe)
    pipe.flush_pipeline()
    assert pipe.get_current_log()["skipped_nonfinite"] == 0.0
    return pipe, p1


def _rel_l2(got, want):
    num = sum(float(((got[k] - v).astype(np.float64) ** 2).sum()) for k, v in want.items())
    return (num / sum(float((v.astype(np.float64) ** 2).sum()) for v in want.values())) ** 0.5


@pytest.mark.parametrize("split", ["residual", "reencode"])
def test_codec_pipeline_second_update_is_stale_by_one(step_pair, split):
    """Update 2 against a step built by hand from the serial model after
    update 1 (P1): the decode side (prior, surrogate, decode) at P1; the
    encode side at the parameters before update 1 (P0) under ``residual``,
    its gradient added onto P1's before the clip; at P1 under ``reencode``
    (then the serial step at P1). Compared as the update P2 - P1, to 1e-6
    relative l2; the stale update differs from the serial one at P1."""
    _, _, tree, x, c1 = step_pair
    x2, c2 = _second_batch()
    pipe, p1 = _two_pipelined_updates(tree, split, x, c1, x2, c2)

    def after_update_1():
        m = CodecModel(_train_opt(), device="cpu")
        m.load_jax_params(tree)
        m.feed_data({"GT": x})
        m.optimize_parameters(0, codec_out=c1)
        m.feed_data({"GT": x2})
        return m

    serial = after_update_1()
    np.testing.assert_equal(_flat_params(serial), p1)
    serial.optimize_parameters(1, codec_out=c2)
    ref = after_update_1()
    if split == "reencode":
        ref.optimize_parameters(1, codec_out=c2)
    else:
        enc = CodecModel(_train_opt(), device="cpu")
        enc.load_jax_params(tree)
        enc.feed_data({"GT": x2})
        lf = enc._encode_lf(enc._hr)
        ref.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            ref_l = ref.degrade(ref._hr)
        loss, _ = ref._loss(lf, ref._hr, ref_l, torch.from_numpy(c2), 16)
        loss.backward()
        for (k, p), (_, e) in zip(ref.net.named_parameters(), enc.net.named_parameters()):
            if e.grad is not None:
                p.grad = e.grad.clone() if p.grad is None else p.grad + e.grad
        clip_by_global_norm_(list(ref.params.parameters()), TRAIN["gradient_clipping"])
        ref.optimizer.step()
    delta = {k: v - p1[k] for k, v in _flat_params(ref).items()}
    got = {k: v - p1[k] for k, v in _flat_params(pipe).items()}
    assert _rel_l2(got, delta) <= 1e-6
    stale = {k: v - p1[k] for k, v in _flat_params(serial).items()}
    assert (_rel_l2(stale, delta) > 1e-3) == (split == "residual")


@pytest.fixture(scope="module")
def jax_second_updates(step_pair):
    """Update 2 of the JAX package's pipelined step (``_optimize_pipelined``
    / ``_retire`` -> ``_train_step``), one ``jax.jit`` from the parameters
    before update 1 (P0) and that update's gradients: update 1's clip +
    Adam gives P1 and Adam's state; then batch 2's encode under ``jax.vjp``
    at P0 (its residuals are those of the encode ``_retire`` pulls the
    gradient through), the loss's gradient at P1 with that LF, the encode's
    pulled back and added, and clip + Adam from P1. ``reencode``: the same
    with the encode at P1 (``_train_step_reencode``). Returns P1 and
    {split: P2}, as flat trees."""
    jax_step, _, tree, x, c1 = step_pair
    x2, c2 = _second_batch()
    jm, tx, hr2, key = _jax_codec(), _jax_tx(), jnp.asarray(x2), jax.random.PRNGKey(0)

    def grads(p_enc, p_dec):
        lf, enc_vjp = jax.vjp(lambda q: jm._encode_lf(q, hr2), p_enc)
        g, g_lf = jax.grad(lambda q, l: jm._loss(q, l, hr2, jm.degrade(hr2), jnp.asarray(c2), key,
                                                 jnp.float32(16))[0], argnums=(0, 1))(p_dec, lf)
        return jax.tree.map(jnp.add, g, enc_vjp(g_lf)[0])

    def adam(p, state, g):
        u, state = tx.update(g, state, p)
        return jax.tree.map(lambda a, b: a - TRAIN["lr_G"] * b, p, u), state

    def two(p0, g1):
        p1, s1 = adam(p0, tx.init(p0), g1)
        # the encode at P0 and at P1: one traced body, run twice
        g2 = jax.lax.map(lambda p_enc: grads(p_enc, p1), jax.tree.map(lambda a, b: jnp.stack([a, b]), p0, p1))
        return p1, {split: adam(p1, s1, jax.tree.map(lambda g: g[i], g2))[0]
                    for i, split in enumerate(("residual", "reencode"))}

    p1, p2 = jax.jit(two)(tree, jax_step["grads"])
    return flatten_tree(jax.tree.map(np.asarray, p1)), {k: flatten_tree(jax.tree.map(np.asarray, v))
                                                       for k, v in p2.items()}


@pytest.mark.parametrize("split", ["residual", "reencode"])
def test_codec_pipeline_second_update_matches_jax(step_pair, jax_second_updates, split):
    """The port's two pipelined updates against the JAX package's: P1
    within 1e-5 abs (as the serial step), update 2 (P2 - P1, each side
    from its own P1) within 1e-4 relative l2, the gradient tree's bound; the
    stale update differs from the live one by more than that on the JAX
    side."""
    _, _, tree, x, c1 = step_pair
    want_p1, want_p2 = jax_second_updates
    pipe, p1 = _two_pipelined_updates(tree, split, x, c1, *_second_batch())
    for k, v in want_p1.items():
        assert np.abs(p1[k] - v).max() <= 1e-5, k
    want = {k: v - want_p1[k] for k, v in want_p2[split].items()}
    got = {k: v - p1[k] for k, v in _flat_params(pipe).items()}
    err = _rel_l2(got, want)
    other = {k: v - want_p1[k] for k, v in want_p2["reencode" if split == "residual" else "residual"].items()}
    print(f"update 2 against JAX: {err:.3e} relative l2; stale against live {_rel_l2(other, want):.3e}")
    assert err <= 1e-4
    assert _rel_l2(other, want) > 1e-3


def test_codec_pipeline_flushes_before_save_and_test(step_pair, tmp_path, monkeypatch):
    """``save`` and ``test`` retire the batch in flight first: the saved
    file holds the serial step's parameters."""
    monkeypatch.setenv("SELFC_TPU_DISABLE_X265", "1")
    _, port_step, tree, x, codec_out = step_pair
    model = _pipelined(tree, "residual", standin_codec="zlib")
    model.opt["path"] = {"models": str(tmp_path)}
    model.feed_data({"GT": x})
    model.optimize_parameters(0, codec_out=codec_out)
    saved = flatten_tree(read_msgpack(model.save(0)))
    assert model._pending is None
    want = flatten_tree(port_step["params"])
    for k, v in saved.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    model.optimize_parameters(1, codec_out=codec_out)
    assert model._pending is not None
    model.test()
    assert model._pending is None and model.fake_H.shape == CLIP


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
