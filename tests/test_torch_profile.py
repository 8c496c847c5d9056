"""The port's profiler (``selfc_tpu_torch/utils/profile.py``), the trace
split by kernel (``selfc_tpu_torch/tools/profile_step.py``) and the two
helpers of ``utils/logger.py`` against the JAX package, on the CPU.

``count_params``: the JAX tree of every model type ``define_G`` builds, and
of D and F, from ``jax.eval_shape`` of ``init`` (which computes nothing),
cut in depth (tracing a full-width JAX net costs several seconds): the same
count by the same formula as the port's module at the same options; then the
port alone at the published widths, held to the counts ``PERF.md`` §4
records (every one of them the JAX count at full width, checked once when
this test was written). ``cost_analysis``: the plain D2DT chain against the
hand count of its products under ``FlopCounterMode``'s convention (2 flops a
multiply-add, every output position, biases and activations nothing).
``StepTimer``, ``ProgressBar``: the clock patched in ``time`` itself, which
both packages read. ``attribute``: a hand-made chrome trace, every number
exact.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfc_tpu.codec import surrogate as jsur
from selfc_tpu.config import dict_to_nonedict as jnonedict
from selfc_tpu.models import discriminator as jdisc
from selfc_tpu.models import factory as jfactory
from selfc_tpu.utils import logger as jlogger
from selfc_tpu.utils import profile as jprofile
from selfc_tpu_torch.codec import surrogate as tsur
from selfc_tpu_torch.config import dict_to_nonedict
from selfc_tpu_torch.models import define_G
from selfc_tpu_torch.models import discriminator as tdisc
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.tools import profile_step
from selfc_tpu_torch.utils import logger as tlogger
from selfc_tpu_torch.utils import profile as tprofile
from selfc_tpu_torch.utils.bench import make_chain

G4 = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [4, 4], "scale": 4, "init": "xavier",
      "global_module": "nonlocal", "stp_blk_num": 6, "fh_loss": "gmm", "gmm_k": 5}
CODEC = {"which_model_G": {"subnet_type": "D2DTNet"}, "in_nc": 3, "out_nc": 3, "block_num": [4], "scale": 2,
         "init": "xavier", "global_module": "nonlocal", "stp_blk_num": 4, "fh_loss": "l2", "stp_hidden_c": 24,
         "stp_denseblock_innerc": 12}
HAAR = {"which_model_G": {"subnet_type": "D2DTNet"}, "block_num": [4, 4], "scale": 4}
IRN = {"which_model_G": {"subnet_type": "DBNet"}, "block_num": [8, 8], "scale": 4}
# model type: (network_G at full width, the cut for the JAX comparison, the published count)
G_CASES = {"SelfC_GMM": (G4, {"block_num": [1, 1], "stp_blk_num": 1}, 3_365_038),
           "SelfC_GMM_Codec": (CODEC, {"block_num": [1], "stp_blk_num": 1}, 885_524),
           "SelfC": (HAAR, {"block_num": [1, 1]}, 2_215_699),
           "IRN": (IRN, {"block_num": [1, 1]}, 4_355_136)}
KEYS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g_opt(model, net):
    return {"model": model, "scale": net["scale"], "network_G": net}


@pytest.mark.parametrize("model", sorted(G_CASES))
def test_count_params_matches_jax_for_every_model_type(model):
    net, cut, published = G_CASES[model]
    small = {**net, **cut}
    jnet = jfactory.define_G(jnonedict(_g_opt(model, small)))
    image = model == "IRN"
    x = jnp.zeros((1, 16, 16, 3) if image else (1, 3, 16, 16, 3))
    shapes = jax.eval_shape(lambda: jnet.init(KEYS, x, **({} if image else {"method": jnet.roundtrip})))["params"]
    got = tprofile.count_params(define_G(dict_to_nonedict(_g_opt(model, small)), device="cpu"))
    assert got == jprofile.count_params(shapes) and got < published
    assert tprofile.count_params(define_G(dict_to_nonedict(_g_opt(model, net)), device="cpu")) == published


@pytest.mark.parametrize("which", ["surrogate", "D", "F"])
def test_count_params_matches_jax_for_the_surrogate_d_and_f(which):
    """The codec's surrogate (the JAX count at full width: it is cheap to
    trace), D at nf 8 against JAX and at nf 64 alone, F cut to conv1_2
    against JAX and whole (to conv5_4) alone."""
    if which == "surrogate":
        shapes = jax.eval_shape(lambda: jsur.H265Surrogate(dynamic_q=False).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3, 8, 8, 3)), jnp.float32(16.0)))["params"]
        got = tprofile.count_params(tsur.H265Surrogate(False))
        assert got == jprofile.count_params(shapes) == 26_066_739
        return
    if which == "D":
        shapes = jax.eval_shape(lambda: jdisc.DiscriminatorVGG128(in_nc=3, nf=8).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))["params"]
        d = lambda nf: tdisc.define_D(dict_to_nonedict(  # noqa: E731
            {"network_D": {"which_model_D": "discriminator_vgg_128", "in_nc": 3, "nf": nf}}), 32 if nf == 8 else 144,
            device="cpu")
        assert tprofile.count_params(d(8)) == jprofile.count_params(shapes)
        assert tprofile.count_params(d(64)) == 14_499_401
        return
    shapes = jax.eval_shape(lambda: jdisc.VGGFeatureExtractor(feature_layer=2).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))["params"]
    assert tprofile.count_params(tdisc.VGGFeatureExtractor(feature_layer=2, device="cpu")) == \
        jprofile.count_params(shapes)
    assert tprofile.count_params(tdisc.define_F(device="cpu")) == 20_024_384


def test_count_params_of_a_tree():
    tree = {"a": np.zeros((3, 4)), "b": [torch.zeros(5), {"c": np.zeros((2, 2, 2))}], "d": (np.zeros(1),)}
    assert tprofile.count_params(tree) == jprofile.count_params(tree) == 12 + 5 + 8 + 1


def test_cost_analysis_of_the_plain_chain_is_the_hand_count():
    B, T, H, W, C, gc, c_out = 1, 2, 6, 7, 3, 8, 5
    x, ws, bs, w5, b5, _, _ = make_chain(np.random.default_rng(0), C, c_out, (B, T, H, W), "cpu", gc=gc)
    macs = sum(9 * (C + k * gc) * gc for k in range(4)) + 3 * (C + 4 * gc) * c_out
    got = tprofile.cost_analysis(dc.dense_chain_t_ep_plain, x, ws, bs, w5, b5)
    assert got == {"flops": 2.0 * B * T * H * W * macs}


def _fake_clock(monkeypatch, name, values):
    it = iter(values)
    monkeypatch.setattr(time, name, lambda: next(it))


def test_step_timer_ema_equals_jax(monkeypatch):
    stamps = [10.0, 10.5, 11.0, 11.25, 12.0, 12.75, 13.0, 13.0625]
    out = {}
    for tag, timer in (("jax", jprofile.StepTimer(ema=0.9)), ("port", tprofile.StepTimer("cpu", ema=0.9))):
        _fake_clock(monkeypatch, "perf_counter", stamps)
        dts = []
        for _ in range(4):
            timer.tic()
            dts.append(timer.toc())
        out[tag] = (dts, timer.avg)
    assert out["port"] == out["jax"] and out["port"][0] == [0.5, 0.25, 0.75, 0.0625]
    port = tprofile.StepTimer("cpu")
    assert port.clock == "host" and port.read() is None and port.mean is None


def test_trace_writes_a_chrome_trace_that_parses(tmp_path):
    """On the CPU: CPU activities only, so the split finds no device event
    and an idle window."""
    with tprofile.trace(str(tmp_path), "cpu") as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / tprofile.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    split = profile_step.attribute(str(tmp_path / tprofile.TRACE_FILE))
    assert split["device_events"] == 0 and split["busy_ms"] == 0.0 and split["idle_share"] == 1.0


def test_trace_closes_when_the_body_raises(tmp_path):
    with pytest.raises(RuntimeError, match="inside the window"):
        with tprofile.trace(str(tmp_path)):
            torch.ones(4).sum()
            raise RuntimeError("inside the window")
    with open(tmp_path / tprofile.TRACE_FILE) as f:
        assert any(e.get("name") == "aten::sum" for e in json.load(f)["traceEvents"])
    assert os.listdir(tmp_path) == [tprofile.TRACE_FILE]
    assert not torch.autograd.profiler._is_profiler_enabled


LAYER = "void tc::chain_layer_kernel<float, tc::SpatialTile<8, 16, 4>, 32, {}>(tc::ChainLayerArgs<float>)"
ANON = "void (anonymous namespace)::{}"
LIBRARY = "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x128x32_cudnn"
TORCH = ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
         "at::detail::Array<char*, 1> >(int, at::native::FillFunctor<float>, at::detail::Array<char*, 1>)")
# (name, ts, dur) in microseconds, all on one stream; busy [100, 180],
# [200, 260], [400, 500], [700, 750] in a window [0, 1000]
KERNELS = [(LAYER.format("true, 0, false, false"), 100, 50),
           (ANON.format("chain_conv5_kernel<float, tc::TileWide, 16>(tc::TconvArgs<float>)"), 150, 30),
           (ANON.format("weight_grad_kernel<float, 32, true>((anonymous namespace)::BwdArgs<float>)"), 200, 20),
           (ANON.format("reduce_partials_kernel<float>(float const*, int, int, int, float*, float*)"), 220, 10),
           (ANON.format("deform_backward_kernel<float>((anonymous namespace)::DeformArgs<float>)"), 230, 20),
           (ANON.format("reduce_partials_kernel<float>(float const*, int, int, float*)"), 250, 10),
           (ANON.format("temporal_conv3_kernel<float, tc::TileNarrow8, 16>(tc::TconvArgs<float>)"), 400, 40),
           (LAYER.format("false, 0, false, true"), 440, 10),
           (LAYER.format("false, 0, true, false"), 450, 10),
           (LAYER.format("false, 16, false, false"), 460, 10),
           (LIBRARY, 470, 30),
           (TORCH, 700, 50)]


def _hand_trace():
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": d, "pid": 0, "tid": 7, "args": {"stream": 7}}
          for n, ts, d in KERNELS]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 1000, "pid": 1, "tid": 1},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 520, "dur": 150, "pid": 1,
            "tid": 1},
           {"ph": "i", "name": "marker", "ts": 5000, "pid": 1, "tid": 1}]
    return {"traceEvents": ev}


def test_attribute_splits_a_hand_made_trace():
    got = profile_step.attribute(_hand_trace())
    ms = {b: (round(v["ms"], 9), v["events"]) for b, v in got["buckets"].items()}
    assert ms == {"B1/B3": (0.08, 2), "B2": (0.03, 2), "B5": (0.03, 2), "B6": (0.04, 1), "B7": (0.01, 1),
                  "B8": (0.01, 1), "B9": (0.01, 1), "library": (0.03, 1), "other": (0.05, 1)}
    assert abs(got["buckets"]["B1/B3"]["share"] - 80 / 290) < 1e-12
    assert got["device_events"] == 12 and got["window_ms"] == 1.0 and got["busy_ms"] == 0.29
    assert abs(got["idle_share"] - 0.71) < 1e-12 and got["unattributed"] == []
    assert [(g["start_ms"], g["ms"]) for g in got["gaps"]] == [(0.75, 0.25), (0.5, 0.2), (0.26, 0.14), (0.0, 0.1),
                                                               (0.18, 0.02)]
    assert got["gaps"][1]["host_ops"] == [["aten::conv2d", 0.2], ["cudaStreamSynchronize", 0.15]]
    # PyTorch's own kernels may sit in an anonymous namespace too: a kernel is
    # this package's by its symbol, one of the csrc sources' __global__ functions
    softmax = ANON.format("softmax_warp_forward<float, float, float, 3, false, false>(float*, float const*, int)")
    assert profile_step.bucket_of(softmax) == "other" and "softmax_warp_forward" not in profile_step.package_kernels()
    assert {profile_step._symbol(n)[0] for n, _, _ in KERNELS[:10]} <= profile_step.package_kernels()


def test_expected_events_and_main(tmp_path, capsys):
    """Kernels a wrapper's call makes, and ``main`` over a directory with a
    trace and the wrappers' calls of its window."""
    counts = {"B1": 2, "B3": 1, "B2": 3, "B2_dx": 2, "B5": 1, "B5_bwd": 1, "B6": 2, "B6_bwd": 1, "B6_split": 1,
              "B7": 1, "B8": 0, "B9": 1}
    assert profile_step.expected_events(counts) == {"B1/B3": 14, "B2": 38, "B5": 5, "B6": 4, "B7": 5, "B8": 0,
                                                    "B9": 5}
    with open(tmp_path / tprofile.TRACE_FILE, "w") as f:
        json.dump(_hand_trace(), f)
    with open(tmp_path / "launches.json", "w") as f:
        json.dump({"first_iter": 4, "last_iter": 6, "counts": {"B1": 0, "B6": 1, "B6_split": 0}}, f)
    assert profile_step.main([str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["events_vs_launches"] == {"B1/B3": [2, 0], "B6": [1, 1]} and out["device_events"] == 12


def test_launch_counts_reads_every_wrapper():
    got = tprofile.launch_counts()
    assert set(got) == set(profile_step.KERNELS_A_CALL) and all(isinstance(v, int) for v in got.values())


def test_progress_bar_prints_as_jax(monkeypatch, capsys):
    out = {}
    for tag, cls in (("jax", jlogger.ProgressBar), ("port", tlogger.ProgressBar)):
        for n in (3, 0):
            _fake_clock(monkeypatch, "time", [100.0, 100.5, 101.25, 103.0])
            pb = cls(task_num=n)
            for _ in range(3):
                pb.update("step")
        out[tag] = capsys.readouterr().out
    assert out["port"] == out["jax"] and "3/3" in out["port"]


def test_tensor2heatmap_bytes_equal_jax():
    rng = np.random.default_rng(6)
    for x, mm in ((rng.random((8, 9)), None), (rng.random((5, 6, 3)), None), (rng.normal(size=(4, 4)), (-1.0, 1.0))):
        got, want = tlogger.tensor2heatmap(x, mm), jlogger.tensor2heatmap(x, mm)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape and got.tobytes() == want.tobytes()
