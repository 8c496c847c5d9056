"""The third slice of the port: the SelfC_GMM_Codec compression eval
(``SelfCNetCodec``, ``define_G``, the host codec bridge, the streaming
pipeline, ``CodecModel.test``) against the JAX package, fp32, on the CPU.

Parameters come from ``jax.eval_shape`` plus a numpy-seeded tree and flax
``apply`` runs eagerly (jitted where the pipeline calls it); the JAX
``CodecModel`` is never built (its ``__init__`` initialises a net). The host codec is pinned to the zlib
stand-in on both sides where the comparison must be bit for bit.

Tolerances: the net's latent after one coupling block and the HR after the
codec prior + one inverse block, atol 1e-4 (chains, exp and products
compound, as tests/test_torch_roundtrip.py); the stand-in codec and the
pipeline are numpy on both sides, so their bytes, bpp and frames are equal
exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.codec import h265 as jh265
from selfc_tpu.codec import pipeline as jpipeline
from selfc_tpu.codec import standin as jstandin
from selfc_tpu.models.inv_nets import SelfCNetCodec as JSelfCNetCodec
from selfc_tpu.ops.quantize import quantize_ste as jquantize_ste
from selfc_tpu_torch.codec import h265, pipeline, standin
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models import define_G
from selfc_tpu_torch.models.inv_nets import SelfCNetCodec
from selfc_tpu_torch.train.codec_model import CodecModel
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
# the published codec net cut in depth: one coupling block, a 2-block prior
# (hidden 24, growth 12, nonlocal, l2 tail), scale 2
SMALL = dict(scale=2, block_num=(1,), stp_blk_num=2)
ATOL = 1e-4


def _clip(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.fixture
def standin_pinned(monkeypatch):
    """The zlib stand-in on both stacks, even where a real x265 exists."""
    monkeypatch.setenv("SELFC_TPU_DISABLE_X265", "1")
    monkeypatch.delenv("SELFC_TPU_STANDIN_CODEC", raising=False)


@pytest.fixture(scope="module")
def stacks():
    """(jax module, its numpy param tree, the port's module with the same
    parameters): the tree loads into the port rename-free."""
    x = _clip(0, (1, 3, 16, 16, 3))
    jm = JSelfCNetCodec(**SMALL)
    tree = seeded_tree(jm, 1, jnp.asarray(x), method=jm.roundtrip)
    tm = SelfCNetCodec(device="cpu", **SMALL)
    load_jax_params(tm, tree)
    return jm, tree, tm.eval()


def _japply(jm, tree, *args, method, **kw):
    return jm.apply({"params": tree}, *args, method=method, **kw)


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------


def test_codec_encode_matches_jax(stacks):
    jm, tree, tm = stacks
    x = _clip(2, (1, 3, 16, 16, 3))
    want, want_jac = _japply(jm, tree, jnp.asarray(x), method=jm.encode)
    with torch.no_grad():
        got, jac = tm.encode(torch.from_numpy(x))
    assert got.shape == (1, 3, 8, 8, 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(jac.item(), float(want_jac), rtol=1e-4, atol=1e-3)


def test_codec_decode_with_hf_matches_jax(stacks):
    jm, tree, tm = stacks
    lr = np.round(_clip(3, (1, 3, 8, 8, 3)) * 255) / 255
    hf = np.random.default_rng(4).normal(0, 0.5, (1, 3, 8, 8, 12)).astype(np.float32)
    want, want_y = _japply(jm, tree, jnp.asarray(lr), jnp.asarray(hf),
                           method=jm.decode_with_hf)
    with torch.no_grad():
        got, got_y = tm.decode_with_hf(torch.from_numpy(lr), torch.from_numpy(hf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL)


def test_codec_decode_matches_jax(stacks):
    """fh_loss 'l2': the prior's output is the HF, nothing is sampled, so
    the whole decode is comparable."""
    jm, tree, tm = stacks
    lr = np.round(_clip(5, (1, 3, 8, 8, 3)) * 255) / 255
    want, want_hf = _japply(jm, tree, jnp.asarray(lr), method=jm.decode,
                            rngs={"sample": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got, hf = tm.decode(torch.from_numpy(lr))
    np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_codec_roundtrip_matches_jax(stacks):
    """The codec-free roundtrip: the pre-quantisation LR atol 1e-4; the
    quantised LR equal (no latent of this clip lies within the stacks'
    difference of a rounding boundary), so ``hr`` atol 1e-4."""
    jm, tree, tm = stacks
    x = _clip(11, (1, 3, 16, 16, 3))
    want = _japply(jm, tree, jnp.asarray(x), method=jm.roundtrip)
    with torch.no_grad():
        got = tm.roundtrip(torch.from_numpy(x))
    np.testing.assert_allclose(got["lr_pre_quant"].numpy(), np.asarray(want["lr_pre_quant"]), atol=ATOL)
    np.testing.assert_array_equal(got["lr"].numpy(), np.asarray(want["lr"]))
    np.testing.assert_allclose(got["hr"].numpy(), np.asarray(want["hr"]), atol=ATOL)
    assert got["loss_c"].item() == 0.0


def _jax_tree_shapes(jm):
    """{dot-joined name: shape} of the JAX net's parameters, from
    ``jax.eval_shape`` (no values are computed)."""
    x = jnp.zeros((1, 3, 16, 16, 3))
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "sample": jax.random.PRNGKey(1)},
                                            x, method=jm.roundtrip))["params"]
    return {".".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def test_codec_deart_net_builds_the_jax_tree():
    """``deart_net=True`` adds the de-artifact net with the JAX net's leaf
    names and shapes (``deart_0`` / ``deart_2`` D2DT chains, ``deart_1`` the
    grouped deformable aggregation over 3 frames)."""
    tm = SelfCNetCodec(device="cpu", deart_net=True, **SMALL)
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == _jax_tree_shapes(JSelfCNetCodec(deart_net=True, **SMALL))
    assert got["deart_1.offset_w"] == (3, 3, 32, 54) and got["deart_2.chain.conv5.weight"] == (3, 160, 3)


def _codec_opt(**network_g):
    return dict_to_nonedict({
        "model": "SelfC_GMM_Codec", "scale": 2, "distortion": "sr_bd",
        "network_G": {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [1],
                      "scale": 2, "init": "xavier", "global_module": "nonlocal",
                      "stp_blk_num": 2, "h265_deart": False, "h265_q": 9,
                      "h265_keyint": -1, "h265_all_default": True, "fh_loss": "l2",
                      "stp_hidden_c": 24, "stp_denseblock_innerc": 12, **network_g},
    })


def test_define_g_builds_the_published_codec_net(tmp_path, monkeypatch):
    """The port's parser reads the shipped UVG codec config to the JAX
    package's options, and ``define_G`` builds the full-width net from them
    with the JAX net's parameter names and count. As in the JAX package's
    factory, ``h265_deart: True`` alone changes nothing (no module reads
    it) and ``deart_net: True`` adds the de-artifact net."""
    from selfc_tpu import config as jconfig
    from selfc_tpu_torch import config as tconfig

    monkeypatch.chdir(tmp_path)
    yml = os.path.join(ROOT, "selfc_tpu", "configs", "test", "test_codec_uvg_bf.yml")
    opt = tconfig.parse(yml, is_train=False)
    assert opt == jconfig.parse(yml, is_train=False)
    net = define_G(opt, device="cpu")
    assert isinstance(net, SelfCNetCodec) and net.n_blocks == 4 and net.scale == 2
    chains = [m for m in net.modules() if type(m).__name__ == "DenseChain"]
    assert sorted({m.conv1.weight.shape[-1] for m in chains}) == [12, 32]
    flat = _jax_tree_shapes(JSelfCNetCodec(scale=2, block_num=(4,), stp_blk_num=4))
    assert flat == {k: tuple(p.shape) for k, p in net.named_parameters()}
    opt["network_G"]["h265_deart"] = True
    assert {k: tuple(p.shape) for k, p in define_G(opt, device="cpu").named_parameters()} == flat
    opt["network_G"]["deart_net"] = True
    flat = _jax_tree_shapes(JSelfCNetCodec(scale=2, block_num=(4,), stp_blk_num=4, deart_net=True))
    assert {k: tuple(p.shape) for k, p in define_G(opt, device="cpu").named_parameters()} == flat
    assert any(k.startswith("deart_1.") for k in flat)


def test_define_g_codec_block_num_default_follows_jax():
    """Without ``network_G.block_num`` both factories build (4, 4) coupling
    blocks for the codec too (selfc_tpu/models/factory.py): one option dict
    gives one parameter tree on both sides."""
    from selfc_tpu.models.factory import define_G as jdefine_G

    opt = _codec_opt()
    del opt["network_G"]["block_num"]
    jnet = jdefine_G(opt)
    assert tuple(jnet.block_num) == (4, 4)
    net = define_G(opt, device="cpu")
    assert net.block_num == (4, 4) and net.n_blocks == 8
    assert {k: tuple(p.shape) for k, p in net.named_parameters()} == _jax_tree_shapes(jnet)


# ---------------------------------------------------------------------------
# the host codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keyint", [-1, 3])
@pytest.mark.parametrize("q", [9, 21])
def test_zlib_codec_matches_jax_bit_for_bit(q, keyint):
    frames = np.clip(_clip(6, (7, 16, 24, 3)) * 0.3 + np.linspace(0, 0.7, 24)[:, None], 0, 1)
    outs = []
    for mod in (standin, jstandin):
        c = mod.ZlibCodec(q, keyint, 2)
        c.open_writer(24, 16)
        c.write_multi_frames(frames[:4])
        c.write_multi_frames(frames[4:])
        bpp = c.close_writer()
        c.open_reader()
        dec = np.concatenate([c.read_multi_frames(3), c.read_multi_frames(4)])
        outs.append((c._bitstream, bpp, dec))
    (bits, bpp, dec), (jbits, jbpp, jdec) = outs
    assert bits == jbits and bpp == jbpp and bpp > 0
    np.testing.assert_array_equal(dec, jdec)
    assert standin.q_to_step(q) == jstandin.q_to_step(q)
    dec1, bpp1 = standin.zlib_encode_decode_clip(frames, q, keyint, 2)
    assert bpp1 == bpp
    np.testing.assert_array_equal(dec1, dec)


def test_codec_resolution_follows_the_environment(standin_pinned, monkeypatch):
    """The same environment names as the JAX package pick the same host
    codec: disabled x265 -> the zlib stand-in, or NullCodec on request."""
    assert h265.codec_backend() is None and not h265.ffmpeg_available()
    assert h265.rate_source() == jh265.rate_source() == "zlib"
    assert type(h265.make_stream(9, -1, 2)).__name__ == "ZlibCodec"
    monkeypatch.setenv("SELFC_TPU_STANDIN_CODEC", "null")
    assert h265.rate_source() == jh265.rate_source() == "formula"
    assert type(h265.make_stream(9, -1, 2)).__name__ == "NullCodec"
    assert h265.rate_source("zlib") == "zlib"


def test_real_x265_matches_jax():
    """Where the port finds a real x265 (the ffmpeg CLI or its own native
    tool, built from its own copy of the source), both stacks' one-shot
    clip roundtrip gives the same decoded frames and bpp."""
    if os.environ.get("SELFC_TPU_DISABLE_X265"):
        pytest.skip("SELFC_TPU_DISABLE_X265 is set")
    backend = h265.codec_backend()
    if backend is None:
        pytest.skip("no real x265 here (no ffmpeg CLI, no libav to build the native tool)")
    if jh265.codec_backend() is None:
        pytest.skip("the JAX package finds no real x265 here")
    if backend == "native":
        assert h265._native_binary().startswith(os.path.join(ROOT, "selfc_tpu_torch", "build"))
    frames = np.tile(np.linspace(0, 1, 64, dtype=np.float32)[None, None, :, None], (6, 32, 1, 3))
    frames = frames * (0.8 + 0.2 * _clip(7, (6, 32, 64, 1)))
    got, bpp = h265.encode_decode_clip(frames, 17, 3, 2)
    want, jbpp = jh265.encode_decode_clip(frames, 17, 3, 2)
    assert got.shape == (6, 32, 64, 3) and bpp == jbpp and bpp > 0
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the streaming pipeline
# ---------------------------------------------------------------------------


def _fns():
    """The numpy device functions of tests/test_codec.py::TestBatchedPipeline:
    cross-pixel coupling inside each tile, so any tile mix-up shows."""
    def encode_fn(chunk):
        c = np.asarray(chunk, np.float32)
        lr = 0.25 * (c[:, :, ::2, ::2] + c[:, :, 1::2, ::2] + c[:, :, ::2, 1::2] + c[:, :, 1::2, 1::2])
        return lr * 0.9 + 0.01

    def decode_fn(tile):
        t = np.asarray(tile, np.float32)
        up = np.repeat(np.repeat(t, 2, axis=2), 2, axis=3)
        return up + 0.001 * np.cumsum(up, axis=3)

    return encode_fn, decode_fn


def test_segment_padding_matches_jax():
    v = _clip(8, (2, 7, 4, 4, 3))
    segs, pad = pipeline.seg_add_pad(v, 3)
    jsegs, jpad = jpipeline.seg_add_pad(v, 3)
    assert pad == jpad == 2
    np.testing.assert_array_equal(segs, jsegs)
    np.testing.assert_array_equal(pipeline.seg_remove_pad(segs, pad, 3), v)
    assert list(pipeline._group_indices(5, 4)) == list(jpipeline._group_indices(5, 4))


@pytest.mark.parametrize("batch_tiles,seg_batch,overlap", [
    (False, 1, False), (True, 1, False), (True, 1, True), (True, 2, False),
    (True, 2, True), (True, 4, False), (True, 4, True)])
def test_compress_video_matches_jax_bit_for_bit(standin_pinned, batch_tiles, seg_batch, overlap):
    enc, dec = _fns()
    video = _clip(7, (1, 7, 16, 16, 3))  # pads to 3 segments of 3
    kw = dict(batch_tiles=batch_tiles, seg_batch=seg_batch, overlap=overlap)
    got = pipeline.compress_video(enc, dec, video, 17, 12, 2, **kw)
    want = jpipeline.compress_video(enc, dec, video, 17, 12, 2, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] > 0


def test_compress_video_takes_torch_results(standin_pinned):
    """Device functions that return tensors (here on the CPU) reach the
    host through the same helpers and give the same numbers."""
    enc, dec = _fns()
    video = _clip(9, (1, 7, 16, 16, 3))
    want = pipeline.compress_video(enc, dec, video, 17, 12, 2, seg_batch=2)
    got = pipeline.compress_video(lambda c: torch.from_numpy(enc(c)),
                                  lambda t: torch.from_numpy(dec(t)), video, 17, 12, 2, seg_batch=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_batched_call_count(standin_pinned):
    enc, dec = _fns()
    calls = {"enc": 0, "dec": 0}

    def enc_c(x):
        calls["enc"] += 1
        return enc(x)

    def dec_c(x):
        calls["dec"] += 1
        return dec(x)

    video = np.zeros((1, 12, 16, 16, 3), np.float32)  # 4 segments
    pipeline.compress_video(enc_c, dec_c, video, 17, 12, 2, batch_tiles=True, seg_batch=2, overlap=True)
    assert calls == {"enc": 2, "dec": 2}  # against 8 encode + 16 decode calls serially


# ---------------------------------------------------------------------------
# CodecModel
# ---------------------------------------------------------------------------


def test_codec_model_defaults_to_cuda_and_serves_only():
    """The default device is the card; on the CPU only when asked. A model
    built for eval serves only (``optimize_parameters`` needs
    ``is_train``, which the codec's training slice now provides)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodecModel(_codec_opt())
    model = CodecModel(_codec_opt(), device="cpu")
    assert not model.is_train and model.surrogate is None
    with pytest.raises(RuntimeError, match="is_train"):
        model.optimize_parameters(0)


def test_codec_model_test_matches_jax_composition(stacks, standin_pinned):
    """``CodecModel(opt, device='cpu').test()`` against the JAX package's
    own functions composed the way its ``CodecModel.test`` composes them:
    ``SelfCNetCodec`` encode + ``quantize_ste`` and decode, through its
    ``compress_video`` with the stand-in codec. A (1,7,32,32,3) clip pads to
    3 segments of 3, one group of 4 (one padded).

    - the pre-quantisation LR of every encode call: atol 1e-4 (the net);
    - the quantised LR: equal except where a latent lies within the two
      stacks' difference of a rounding boundary, at most 1e-3 of the
      values, each by exactly one level;
    - ``hr`` decoded by the port from the JAX side's encode outputs (one
      shared codec input, so one shared decoded LR): atol 1e-4; the
      decoded LR and the bpp then agree exactly.
    """
    jm, tree, _ = stacks
    clip = _clip(10, (1, 7, 32, 32, 3))
    # each JAX half as one jitted program (eager apply compiles op by op)
    j_enc = jax.jit(lambda t, c: jm.apply({"params": t}, c, method=jm.encode)[0])
    j_dec = jax.jit(lambda t, lr: jm.apply({"params": t}, lr, method=jm.decode,
                                           rngs={"sample": jax.random.PRNGKey(0)})[0])

    j_pre = []

    def j_encode(chunk):
        y = j_enc(tree, jnp.asarray(chunk))
        j_pre.append(np.asarray(y[..., :3]))
        return np.asarray(jnp.concatenate([jquantize_ste(y[..., :3]), y[..., 3:]], -1))

    def j_decode(tile):
        return np.asarray(j_dec(tree, jnp.asarray(tile)))

    j_outs = []

    def j_encode_kept(chunk):
        j_outs.append(j_encode(chunk))
        return j_outs[-1]

    want_lr, want_hr, want_bpp = jpipeline.compress_video(
        j_encode_kept, j_decode, clip, 9, -1, 2, True, batch_tiles=True, seg_batch=4, overlap=True)

    model = CodecModel(_codec_opt(), device="cpu")
    model.load_jax_params(tree)
    assert model.rate_source == "zlib"
    t_pre = []
    encode = model.net.encode

    def recording_encode(x):
        y, jac = encode(x)
        t_pre.append(y[..., :3].numpy().copy())
        return y, jac

    model.net.encode = recording_encode
    assert model.feed_data({"GT": clip}) == 7
    model.test()
    vis, met = model.get_current_visuals(), model.get_current_metrics()
    assert vis["SR"].shape == clip.shape and vis["LR"].shape == (1, 7, 16, 16, 3)
    assert vis["LR_ref"].shape == (1, 7, 16, 16, 3) and np.array_equal(vis["GT"], clip)
    assert met["video_bpp"] > 0 and np.isfinite(vis["SR"]).all()

    assert len(t_pre) == len(j_pre) == 1
    np.testing.assert_allclose(t_pre[0], j_pre[0], atol=ATOL)
    q_t, q_j = (np.round(np.clip(v, 0, 1) * 255) for v in (t_pre[0], j_pre[0]))
    assert np.mean(q_t != q_j) <= 1e-3 and np.abs(q_t - q_j).max() <= 1

    # the port's decode from the JAX side's codec input
    it = iter(j_outs)
    lr_s, hr_s, bpp_s = pipeline.compress_video(
        lambda c: next(it), lambda t: model._decode(model._on_device(t)), clip, 9, -1, 2, True,
        batch_tiles=True, seg_batch=4, overlap=True)
    np.testing.assert_array_equal(lr_s, want_lr)
    assert bpp_s == want_bpp
    np.testing.assert_allclose(hr_s, want_hr, atol=ATOL)
    if np.array_equal(q_t, q_j):  # no level flipped: the port's own run is the same run
        np.testing.assert_array_equal(vis["LR"], want_lr)
        assert met["video_bpp"] == want_bpp
        np.testing.assert_allclose(vis["SR"], hr_s, atol=1e-6)
