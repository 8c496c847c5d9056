"""The port's checkpoints against the JAX package and flax / optax, on the
same bytes, on the CPU: the stdlib msgpack reader and writer against
``flax.serialization`` (the committed iter-164,339 checkpoint leaf for leaf,
bit for bit; the writer's bytes), the ``.pth`` import against the JAX
package's (its ``export_state_dict`` makes the file), the JAX ``.state``
through the stand-in unpickler against the optax pickle, one Adam update
from the restored state against ``optax.scale_by_adam``, and both wrappers
loading ``path.pretrain_model_G``.

Every comparison of loaded values is bit for bit. The Adam update: within
1e-6 of each leaf's largest |update| of optax's. Not elementwise: torch
forms the first moment as ``mu + (1 - b1) (g - mu)`` (a lerp), optax as ``b1
mu + (1 - b1) g``; where the two terms nearly cancel the rounding is of the
terms' size, not the result's.
"""

import os
import pickle

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from selfc_tpu.config import dict_to_nonedict as jnonedict
from selfc_tpu.train import codec_model as jcodec
from selfc_tpu.train import rescale_model as jrescale
from selfc_tpu.utils import torch_import as jti
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.train import checkpoint as ckpt
from selfc_tpu_torch.train.codec_model import CodecModel
from selfc_tpu_torch.train.rescale_model import RescaleModel, clip_by_global_norm_
from selfc_tpu_torch.utils import flax_msgpack as fm
from selfc_tpu_torch.utils import torch_import as tti
from selfc_tpu_torch.utils.jax_import import export_jax_params, flatten_tree, nest_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "runs", "400k")
FULL_NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [4, 4], "scale": 4,
            "init": "xavier", "global_module": "nonlocal", "stp_blk_num": 6, "fh_loss": "gmm",
            "gmm_k": 5}
GMM_NET = dict(FULL_NET, block_num=[1, 1], stp_blk_num=3)
CODEC_NET = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1], "scale": 2,
             "global_module": "nonlocal", "stp_blk_num": 2, "fh_loss": "l2", "h265_q": 16,
             "stp_hidden_c": 24, "stp_denseblock_innerc": 12, "deart_net": True}
TRAIN = {"lr_G": 1e-4, "beta1": 0.9, "beta2": 0.999, "weight_decay_G": 0.0,
         "gradient_clipping": 10, "h265_sug": True, "noise_type": "h265"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side: a thread
    pool as wide as the machine in each worker only makes them wait for
    one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(model, net, is_train, path=None, **top):
    opt = {"model": model, "scale": net["scale"], "distortion": "sr_bd", "is_train": is_train,
           "network_G": net, "path": path or {}, **top}
    if is_train:
        opt["train"] = TRAIN
        opt["datasets"] = {"train": {"video_len": 3, "GT_size": 16}}
    return dict_to_nonedict(opt)


def _bits(a):
    """The bytes of a numpy or torch leaf, with its dtype and shape."""
    if isinstance(a, torch.Tensor):
        return str(a.dtype), tuple(a.shape), a.view(torch.int16).numpy().tobytes() \
            if a.dtype == torch.bfloat16 else a.numpy().tobytes()
    a = np.asarray(a)
    return a.dtype.name, a.shape, a.tobytes()


def _same_tree(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _bits(got[k])[1:] == _bits(want[k])[1:], k


# ---------------------------------------------------------------------------
# the msgpack layout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """The committed checkpoint's bytes, and its tree as flax and as the
    port's reader give it (read once for the module)."""
    path = os.path.join(RUN, "latest_G.msgpack")
    with open(path, "rb") as f:
        data = f.read()
    return path, data, fser.msgpack_restore(data), ckpt.read_msgpack(path)


def test_reader_matches_flax_on_the_trained_checkpoint(trained):
    _, _, want, got = trained
    flat_g, flat_w = flatten_tree(got), flatten_tree(want)
    assert len(flat_w) == 354 and sorted(flat_g) == sorted(flat_w)
    for k, w in flat_w.items():
        assert _bits(flat_g[k]) == _bits(w), k
    assert all(v.flags.writeable for v in flat_g.values())


def _mixed_tree():
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    rng = np.random.default_rng(3)
    return {"ints": ints, "floats": [1.5, -0.0, 1e300], "none": None, "flags": [True, False],
            "strs": ["", "x" * 31, "y" * 32, "z" * 300, "w" * 70000], "bytes": [b"", b"a" * 300],
            "scalars": {"f32": np.float32(2.5), "f64": np.float64(-3.0), "i64": np.int64(7),
                        "b": np.bool_(True)},
            "arrays": {"u8": rng.integers(0, 255, (3, 100), dtype=np.uint8),
                       "i32": np.arange(5, dtype=np.int32), "empty": np.zeros((0, 3), np.float32),
                       "f16": rng.random((2, 2)).astype(np.float16), "bool": np.array([True, False])},
            "many": {f"k{i}": i for i in range(20)}, "long_list": list(range(20))}


@pytest.mark.parametrize("which", ["trained", "mixed"])
def test_writer_bytes_equal_flax(trained, which):
    """The writer's bytes are flax's for the same tree (the trained one is
    also the committed file), and flax reads them back."""
    tree = trained[2] if which == "trained" else _mixed_tree()
    data = fm.msgpack_serialize(tree)
    assert data == fser.msgpack_serialize(tree)
    if which == "trained":
        assert data == trained[1]
        _same_tree(fser.msgpack_restore(data), tree)
    else:
        back = fm.msgpack_restore(data)
        assert back["ints"] == tree["ints"] and back["strs"] == tree["strs"]
        assert back["bytes"] == tree["bytes"] and back["floats"] == tree["floats"]
        assert type(back["scalars"]["f32"]) is np.float32 and back["scalars"]["f32"] == 2.5
        _same_tree(back["arrays"], tree["arrays"])


def test_bfloat16_leaf_read_back():
    """flax's bfloat16 leaf (ml_dtypes through JAX) is read as a
    torch.bfloat16 tensor of the same bits; the port writes one as flax
    does, and flax reads it back."""
    w = np.asarray(jnp.linspace(-3, 3, 12, dtype=jnp.float32).astype(jnp.bfloat16).reshape(3, 4))
    data = fser.msgpack_serialize({"w": w, "s": w[1, 1]})
    got = fm.msgpack_restore(data)
    assert got["w"].dtype == torch.bfloat16 and tuple(got["w"].shape) == (3, 4)
    assert np.array_equal(got["w"].view(torch.int16).numpy(), w.view(np.int16))
    assert got["s"].dtype == torch.bfloat16 and got["s"].shape == ()
    assert fm.msgpack_serialize({"w": got["w"]}) == fser.msgpack_serialize({"w": w})
    back = fser.msgpack_restore(fm.msgpack_serialize({"w": got["w"]}))
    assert back["w"].dtype.name == "bfloat16" and np.array_equal(back["w"].view(np.int16), w.view(np.int16))


def _ext(code, payload):
    return bytes([0x81, 0xa1, ord("x"), 0xc7, len(payload), code]) + payload


@pytest.mark.parametrize("case", ["complex", "ext 9", "chunked", "dtype"])
def test_reader_refuses_what_it_does_not_know(case):
    """Another ext type, flax's chunked-array marker (leaves over 2**30
    bytes) or a dtype numpy does not know raise; nothing is guessed."""
    if case == "complex":
        data = fser.msgpack_serialize({"c": 1 + 2j})
    elif case == "ext 9":
        data = _ext(9, b"\x93\x90\xa7float32\xc4\x00")
    elif case == "chunked":
        data = fser.msgpack_serialize({"a": {"__msgpack_chunked_array__": True, "shape": {"0": 1}}})
    else:
        data = _ext(1, b"\x93\x90\xa9float8_e9\xc4\x00")
    with pytest.raises(ValueError):
        fm.msgpack_restore(data)


# ---------------------------------------------------------------------------
# the .pth import
# ---------------------------------------------------------------------------


def _reference_key(name):
    """The reference state-dict key of a tree path (map_reference_key's
    inverse, for the gmm and codec nets)."""
    glob = {v: k for k, v in jti._GLOBALAGG_FIELDS.items()}
    deform = {v: k for k, v in jti._DEFORM_AGG_FIELDS.items()}
    p = name.split(".")
    idx = lambda s: int(s.rsplit("_", 1)[1])  # noqa: E731
    if p[0].startswith("inv_blocks_"):
        return f"operations.{idx(p[0]) + 1}.{p[1]}.{p[3]}.{p[4]}"
    if p[0].startswith("deart_"):
        return f"deart_net.{idx(p[0])}." + (f"{p[2]}.{p[3]}" if p[1] == "chain" else deform[p[1]])
    m = p[1]
    if m.startswith("local_m"):
        return f"stp_net.{m}.{p[3]}.{p[4]}"
    if m.startswith("global_m"):
        return f"stp_net.{m}.{glob[p[2]]}"
    if m.startswith("other_local_"):
        return f"stp_net.other_stp_modules.{2 * idx(m)}.{p[3]}.{p[4]}"
    if m.startswith("other_global_"):
        return f"stp_net.other_stp_modules.{2 * idx(m) + 1}.{glob[p[2]]}"
    return f"stp_net.tail_gmm.{2 * idx(m) + 1}.{p[2]}"


def _torch_shape(shape):
    """A reference tensor's shape for a tree leaf: Conv3d (1,3,3) and
    (3,1,1) kernels, Linear for pointwise, biases as they are."""
    if len(shape) == 4:
        return (shape[3], shape[2], 1, shape[0], shape[1])
    if len(shape) == 3:
        return (shape[2], shape[1], shape[0], 1, 1)
    return shape[::-1]


def _write_pth(tree, arch, block_num, path):
    """The tree as a reference ``.pth`` made by the JAX package's
    ``export_state_dict``, keys under a DDP ``module.`` prefix, with a codec
    surrogate key the import skips."""
    template = {"module." + _reference_key(k): np.zeros(_torch_shape(v.shape), np.float32)
                for k, v in flatten_tree(tree).items()}
    if arch == "codec":
        template["module.Quantization_H265_Suggrogate.conv.weight"] = np.ones((2, 3), np.float32)
    sd = jti.export_state_dict(tree, template, arch, block_num)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


@pytest.mark.parametrize("kind", ["rescale", "codec"])
def test_pth_import_matches_jax(sources, kind):
    """The reference ``.pth`` that the JAX package's ``export_state_dict``
    wrote (the SelfC_GMM net with an ``other_stp_modules`` block; the codec
    net with the de-artifact net and a surrogate key): the port's import
    gives the JAX import's tree, which is the exported one."""
    tree, _, pth, from_pth = sources[kind]
    arch, block_num = ("gmm", (1, 1)) if kind == "rescale" else ("codec", (1,))
    got = tti.load_pth(pth, arch, block_num)
    _same_tree(got, from_pth)
    _same_tree(got, tree["net"] if kind == "codec" else tree)


# ---------------------------------------------------------------------------
# the training state
# ---------------------------------------------------------------------------

JAX_MODELS = {"rescale": jrescale.RescaleModel, "codec": jcodec.CodecModel}


def _fed_step(model, lr, seed, norm=None):
    """The port's step on fed gradients (normal, std 1, or scaled to a
    global norm of about ``norm``): the clip, then Adam with coupled weight
    decay, at ``lr``. Returns the gradients by name."""
    named = list((model.net if isinstance(model, RescaleModel) else model.params).named_parameters())
    rng = np.random.default_rng(seed)
    std = 1.0 if norm is None else norm / np.sqrt(sum(p.numel() for _, p in named))
    grads = {k: rng.normal(0, std, tuple(p.shape)).astype(np.float32) for k, p in named}
    for k, p in named:
        p.grad = torch.from_numpy(grads[k].copy())
    clip_by_global_norm_([p for _, p in named], model.train_opt["gradient_clipping"])
    for g in model.optimizer.param_groups:
        g["lr"] = lr
    model.optimizer.step()
    return grads


@pytest.fixture(scope="module")
def port_states(tmp_path_factory):
    """The port's training models (clip 10, weight decay 1e-2; the codec's
    with its surrogate) after one fed step, Adam's step then set to the 400k
    run's 164,330 (at a step of 2 optax's float32 bias correction alone is
    1e-5 from torch's float64 one), the ``.state`` each wrote, and a
    dict-form ``.state`` of the same moments, as the port wrote it before."""
    d = tmp_path_factory.mktemp("states")
    out = {}
    for kind in ("rescale", "codec"):
        model = _model(kind, True, {"training_state": str(d / kind)})
        model.train_opt["weight_decay_G"] = 1e-2
        model.optimizer.param_groups[0]["weight_decay"] = 1e-2
        _fed_step(model, 1e-4, 1)
        for st in model.optimizer.state.values():
            st["step"].fill_(164330.0)
        named = (model.net if kind == "rescale" else model.params).named_parameters()
        old = ckpt.save_training_state(str(d / f"{kind}_dict"), 1, 5, ckpt.adam_state(model.optimizer, named))
        out[kind] = (model, model.save_training_state(1, 5), old)
    return out


@pytest.mark.parametrize("kind,fused", [("rescale", False), ("rescale", True), ("codec", False)],
                         ids=["rescale", "rescale-fused", "codec"])
def test_port_state_resumes_in_jax(port_states, kind, fused):
    """The JAX model's ``resume_training`` reads the port's ``.state``
    (through ``_adapt_opt_state`` into one flat vector under
    ``train.fused_optimizer``), and its ``tx`` (clip, decayed weights, Adam)
    on the next fed gradients gives the port's update at lr 1 (the
    parameters move by the update itself, so no cancellation hides it): per
    leaf within 1e-6 of its largest |update|. Those gradients' global norm
    is 5, under the clip of 10, so both clips pass them unscaled (the fused
    layout's float32 norm of one flat vector is ~1e-6 from torch's). The
    port reads the dict-form ``.state`` it wrote before into the same
    moments."""
    model, path, old = port_states[kind]
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert [type(s) for s in raw["opt_state"]] == [optax.EmptyState] * 2 + [optax.ScaleByAdamState]
    jm = JAX_MODELS[kind].__new__(JAX_MODELS[kind])
    jm.is_train, jm.gan = True, None
    jm.train_opt = jnonedict({**model.train_opt, "fused_optimizer": fused})
    jm.params = jax.tree.map(jnp.asarray, export_jax_params(model.net if kind == "rescale" else model.params))
    jm._build_optimizer()
    payload = jm.resume_training(path)
    assert (payload["epoch"], payload["iter"]) == (1, 5) and int(jm.opt_state[-1].count) == 164330
    assert (jm.opt_state[-1].mu.ndim == 1) if fused else isinstance(jm.opt_state[-1].mu, dict)
    saved = {p: {k: v.clone() for k, v in st.items()} for p, st in model.optimizer.state.items()}
    before = {k: v.copy() for k, v in flatten_tree(export_jax_params(
        model.net if kind == "rescale" else model.params)).items()}
    try:
        grads = nest_tree({k: jnp.asarray(v) for k, v in _fed_step(model, 1.0, 2, norm=5.0).items()})
        if fused:
            flat, unravel = ravel_pytree(jm.params)
            updates = unravel(jax.jit(jm.tx.update)(ravel_pytree(grads)[0], jm.opt_state, flat)[0])
        else:
            updates = jax.jit(jm.tx.update)(grads, jm.opt_state, jm.params)[0]
        after = flatten_tree(export_jax_params(model.net if kind == "rescale" else model.params))
        for k, u in flatten_tree(updates).items():
            want = -np.asarray(u)
            np.testing.assert_allclose(after[k] - before[k], want, rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=k)
        model.optimizer.state.clear()
        model.resume_training(old)
        for p, st in saved.items():
            assert all(torch.equal(model.optimizer.state[p][k], v) for k, v in st.items())
    finally:
        with torch.no_grad():
            for k, p in (model.net if kind == "rescale" else model.params).named_parameters():
                p.copy_(torch.from_numpy(before[k]))
        for p, st in saved.items():
            model.optimizer.state[p] = st


@pytest.fixture(scope="module")
def resumed():
    """The full-width trainer with the committed iter-164,339 state restored
    (weight decay off: the update is scale_by_adam's alone), and the state
    as optax unpickles it."""
    state = os.path.join(RUN, "latest.state")
    with open(state, "rb") as f:
        want = pickle.load(f)
    model = RescaleModel(_opt("SelfC_GMM", FULL_NET, True), device="cpu")
    payload = model.resume_training(state)
    return model, payload, want


def test_jax_state_through_the_stand_in_unpickler(resumed):
    _, payload, want = resumed
    assert (payload["epoch"], payload["iter"], payload["extra"]) == (19, 164339, {})
    adam = want["opt_state"][-1]
    count, mu, nu = ckpt.adam_moments(payload["opt_state"])
    assert count == int(adam.count) == 164330
    _same_tree(mu, adam.mu)
    _same_tree(nu, adam.nu)
    assert [type(s).__name__ for s in payload["opt_state"]] == [type(s).__name__ for s in want["opt_state"]]


def test_restored_moments_and_step_in_torch_adam(resumed):
    model, _, want = resumed
    adam = want["opt_state"][-1]
    mu, nu = flatten_tree(adam.mu), flatten_tree(adam.nu)
    for k, p in model.net.named_parameters():
        st = model.optimizer.state[p]
        assert float(st["step"]) == 164330.0
        assert np.array_equal(st["exp_avg"].numpy(), mu[k]) and np.array_equal(st["exp_avg_sq"].numpy(), nu[k])
    assert (model.start_epoch, model.start_iter) == (19, 164339)


def test_adam_update_from_the_restored_state_matches_optax(resumed):
    """One step of the port's Adam on a fixed gradient, from parameters set
    to zero (so that the step itself is read, with no cancellation),
    against ``optax.scale_by_adam(...).update`` times ``-lr``."""
    model, _, want = resumed
    lr = 1e-4
    rng = np.random.default_rng(5)
    grads = {k: rng.normal(0, 1e-2, tuple(p.shape)).astype(np.float32) for k, p in model.net.named_parameters()}
    saved = {p: {k: v.clone() for k, v in model.optimizer.state[p].items()} for p in model.net.parameters()}
    adam = want["opt_state"][-1]
    mu, nu = flatten_tree(adam.mu), flatten_tree(adam.nu)
    # optax on every 16th leaf (the update is leafwise), the port on all
    some = sorted(grads)[::16]
    jstate = optax.ScaleByAdamState(count=jnp.asarray(adam.count), mu={k: mu[k] for k in some},
                                    nu={k: nu[k] for k in some})
    updates, _ = jax.jit(optax.scale_by_adam(b1=0.9, b2=0.999).update)({k: jnp.asarray(grads[k]) for k in some}, jstate)
    try:
        with torch.no_grad():
            for k, p in model.net.named_parameters():
                p.zero_()
                p.grad = torch.from_numpy(grads[k])
        for g in model.optimizer.param_groups:
            g["lr"] = lr
        model.optimizer.step()
        params = dict(model.net.named_parameters())
        for k in some:
            want_k = -lr * np.asarray(updates[k])
            np.testing.assert_allclose(params[k].detach().numpy(), want_k, rtol=0, atol=1e-6 * np.abs(want_k).max())
    finally:
        for p, st in saved.items():
            model.optimizer.state[p] = st
            p.grad = None


def test_flat_vector_state_unravels_in_ravel_pytree_order(resumed):
    """A state saved under ``train.fused_optimizer`` (one flat vector per
    moment, jax's ``ravel_pytree`` order) restores the same moments."""
    model, _, want = resumed
    adam = want["opt_state"][-1]
    flat = ckpt.ScaleByAdamState(adam.count, np.asarray(ravel_pytree(adam.mu)[0]),
                                 np.asarray(ravel_pytree(adam.nu)[0]))
    names = dict(model.net.named_parameters())
    mu = ckpt.unravel(flat.mu, {k: tuple(p.shape) for k, p in names.items()})
    _same_tree(mu, adam.mu)


def test_port_state_round_trip(resumed, tmp_path):
    """The port writes its ``.state`` (optax's chain state under optax's
    names: the clip's empty state, then Adam's), reads it back through the
    same unpickler, and a resume restores the same moments."""
    model, _, _ = resumed
    model.opt["path"] = {"training_state": str(tmp_path)}
    path = model.save_training_state(3, 1234)
    assert path == str(tmp_path / "1234.state") and not os.path.exists(path + ".tmp")
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert [type(s) for s in raw["opt_state"]] == [optax.EmptyState, optax.ScaleByAdamState]
    assert raw["opt_state"][-1].count.dtype == np.int32 and int(raw["opt_state"][-1].count) == 164330
    before = {p: {k: v.clone() for k, v in model.optimizer.state[p].items()} for p in model.net.parameters()}
    model.optimizer.state.clear()
    model.resume_training(path)
    assert (model.start_epoch, model.start_iter) == (3, 1234)
    for p, st in before.items():
        assert all(torch.equal(model.optimizer.state[p][k], v) for k, v in st.items())


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _model(kind, is_train, path=None, seed=0):
    if kind == "rescale":
        return RescaleModel(_opt("SelfC_GMM", GMM_NET, is_train, path), device="cpu", rng_seed=seed)
    return CodecModel(_opt("SelfC_GMM_Codec", CODEC_NET, is_train, path), device="cpu", rng_seed=seed)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Checkpoints to load, made by the JAX side: for each wrapper, a flax
    msgpack of a seed-0 model's parameters (the codec's a training model's
    ``{net, surrogate}`` tree) and a reference ``.pth`` of its net made by
    ``export_state_dict``, with the tree the JAX package imports from it."""
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for kind, arch, block_num in (("rescale", "gmm", (1, 1)), ("codec", "codec", (1,))):
        tree = export_jax_params(_model(kind, kind == "codec").params if kind == "codec"
                                 else _model(kind, False).net)
        net_tree = tree["net"] if kind == "codec" else tree
        msgpack, pth = str(d / f"{kind}_G.msgpack"), str(d / f"{kind}_G.pth")
        with open(msgpack, "wb") as f:
            f.write(fser.msgpack_serialize(tree))
        _write_pth(net_tree, arch, block_num, pth)
        out[kind] = (tree, msgpack, pth, jti.load_pth(pth, arch, block_num))
    return out


@pytest.mark.parametrize("kind,is_train", [("rescale", False), ("rescale", True), ("codec", False), ("codec", True)],
                         ids=["rescale-serve", "rescale-train", "codec-serve", "codec-train"])
def test_wrapper_loads_pretrain_model_G(sources, kind, is_train):
    """``path.pretrain_model_G`` loads in the constructor, serving and
    training: a msgpack (the codec's ``{net, surrogate}`` tree: the parts the
    model has), then a reference ``.pth`` (the net's keys; a codec
    surrogate keeps its own values)."""
    tree, msgpack, pth, from_pth = sources[kind]
    fresh = _model(kind, is_train, seed=1)
    own = export_jax_params(fresh.params if kind == "codec" else fresh.net)
    model = _model(kind, is_train, {"pretrain_model_G": msgpack}, seed=1)
    got = export_jax_params(model.params if kind == "codec" else model.net)
    want = {k: v for k, v in tree.items() if k in got} if kind == "codec" else tree
    _same_tree(got, want)
    assert any(not np.array_equal(v, flatten_tree(own)[k]) for k, v in flatten_tree(want).items())
    model = _model(kind, is_train, {"pretrain_model_G": pth}, seed=1)
    if kind == "codec":
        got = export_jax_params(model.params)
        _same_tree(got["net"], from_pth)
        if is_train:
            _same_tree(got["surrogate"], own["surrogate"])
    else:
        _same_tree(export_jax_params(model.net), from_pth)


def test_codec_loads_a_bare_net_tree(sources, tmp_path):
    tree = sources["codec"][0]["net"]
    path = str(tmp_path / "bare_G.msgpack")
    ckpt.save_network(tree, str(tmp_path), "bare")
    assert path == os.path.join(str(tmp_path), "bare_G.msgpack")
    model = _model("codec", False, {"pretrain_model_G": path}, seed=1)
    _same_tree(export_jax_params(model.net), tree)


def test_save_network_round_trip(sources, tmp_path):
    """``save`` writes the flax layout atomically; flax and ``load_network``
    read the same bits back."""
    model = _model("rescale", False, {"pretrain_model_G": sources["rescale"][1], "models": str(tmp_path)})
    path = model.save(7)
    assert path == str(tmp_path / "7_G.msgpack") and not os.path.exists(path + ".tmp")
    with open(path, "rb") as f:
        _same_tree(fser.msgpack_restore(f.read()), sources["rescale"][0])
    _same_tree(ckpt.load_network(path, export_jax_params(model.net)), sources["rescale"][0])


@pytest.mark.parametrize("fault", ["unknown key", "shape"])
def test_merge_refuses_an_unknown_key_or_a_wrong_shape(sources, fault):
    template = export_jax_params(_model("rescale", False).net)
    loaded = {"stp_net": {"tail_0": dict(template["stp_net"]["tail_0"])}}
    if fault == "unknown key":
        loaded["stp_net"]["tail_9"] = {"bias": np.zeros(3, np.float32)}
        with pytest.raises(KeyError, match="tail_9"):
            ckpt.merge(template, loaded)
    else:
        loaded["stp_net"]["tail_0"]["bias"] = np.zeros(1, np.float32)
        with pytest.raises(ValueError, match="tail_0.bias"):
            ckpt.merge(template, loaded)
    # a key the checkpoint lacks keeps the template's value
    merged = ckpt.merge(template, {"stp_net": {"tail_0": {"bias": np.ones_like(template["stp_net"]["tail_0"]["bias"])}}})
    assert np.all(merged["stp_net"]["tail_0"]["bias"] == 1)
    assert merged["stp_net"]["tail_0"]["weight"] is template["stp_net"]["tail_0"]["weight"]


def test_pretrain_model_D_names_a25():
    """``path.pretrain_model_D`` (A25, ported) is read by the adversarial
    branch alone: a model without ``train.gan_weight`` builds and holds no
    D, as the JAX package's does (tests/test_torch_gan.py loads one)."""
    model = _model("rescale", False, {"pretrain_model_D": "D.msgpack"})
    assert model.gan is None
