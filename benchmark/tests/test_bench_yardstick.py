"""The frozen yardstick: the cost model against hand counts, the trace
split on a synthetic trace, and the rule that nothing under ``benchmark/``
imports JAX or the JAX package (whole top-level names), nor the reference
the program."""

import ast
from pathlib import Path

import pytest

from benchmark.drivers import codec_eval, serve_gop, train_step
from benchmark.harness import BENCH_DIR, Run
from benchmark.yardstick import cost, selfc_work, trace

GOP_FLOP = 1.80e12     # 54 chains at (1,7,144,176): 32 x 26.7 + 16 x 39.4 + 5 x 57.2 + 28.7 GFLOP


def _run(name):
    return Run(name, 1, 1.0, False, "cpu")


def test_gop_chain_work_is_the_hand_count():
    r = _run("gmm4x.serve.gop")
    w = serve_gop.work(r)
    assert w["chain_fwd_ops"] == pytest.approx(GOP_FLOP, rel=0.01)
    assert len(selfc_work.net_chains(r.cfg)) == 54
    assert w["ops"] > w["chain_fwd_ops"] and "chain_bwd_ops" not in w


def test_one_chain_by_hand():
    # H of a coupling block at the GOP latent: 3 -> 48, growth 32
    B, T, H, W = 1, 7, 144, 176
    macs_sp = B * T * H * W * 9 * 32 * (3 + 35 + 67 + 99) * (3 * H - 2) * (3 * W - 2) / (9 * H * W)
    macs_5 = B * T * H * W * 3 * 131 * 48 * (3 * T - 2) / (3 * T)
    assert cost.chain_cost(B, T, H, W, 3, 48, 0)[0] == pytest.approx(2 * (macs_sp + macs_5), rel=1e-12)
    assert cost.chain_bwd_cost(B, T, H, W, 3)[0] == pytest.approx(4 * macs_sp, rel=1e-12)


def test_training_step_is_three_forwards_and_codec_halves_split():
    r = _run("gmm4x.train.b8")
    w = train_step.work(r)
    fwd = selfc_work.roundtrip_work(r.cfg, (8, 7, 36, 36))
    assert w["ops"] == pytest.approx(3 * fwd["ops"])
    assert w["chain_bwd_bound_s"] > 0
    cw = codec_eval.work(_run("codec.uvg.test"))
    enc = sum(cost.chain_cost(8, 3, 540, 480, C, co, a, gc=g)[0]
              for C, co, g, a in [(12, 3, 32, 1), (3, 12, 32, 0), (3, 12, 32, 2)] * 4)
    dec = sum(cost.chain_cost(16, 3, 270, 480, C, co, a, gc=g)[0]
              for C, co, g, a in [(12, 3, 32, 1), (3, 12, 32, 0), (3, 12, 32, 2)] * 4
              + [(3, 24, 12, 0)] + [(24, 24, 12, 0)] * 3)
    assert cw["chain_fwd_ops"] == pytest.approx(enc + dec, rel=1e-12)


def _kernel(name, ts, dur, tid=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def test_trace_split_on_a_synthetic_trace():
    evs = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 1000, "pid": 1, "tid": 1},
        _kernel("void chain_layer_kernel<float, Tile<8, 16>, 32, 0, 0, false, false>(Params)", 100, 100),
        _kernel("void chain_conv5_kernel<float>(P)", 150, 100),          # overlaps: the union counts it once
        _kernel("void (anonymous namespace)::weight_grad_kernel<float>(P)", 300, 50),
        _kernel("void reduce_partials_kernel(float*)", 350, 10),
        _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 400, 100, tid=9),
        _kernel("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_cublas", 500, 20),
        _kernel("void at::native::elementwise_kernel<128, 4>(int)", 520, 30),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 600, "dur": 100,
         "pid": 0, "tid": 8},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 695, "dur": 300, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 700, "dur": 295, "pid": 1, "tid": 1},
    ]
    a = trace.attribute(evs, (0, 1000))
    assert a["window_s"] == pytest.approx(1e-3)
    # busy: [100,250] + [300,360] + [400,550] + [600,700] = 460 us
    assert a["busy_s"] == pytest.approx(460e-6)
    assert a["idle_share"] == pytest.approx(0.54)
    b = a["buckets"]
    assert b["B1/B3"] == pytest.approx(200e-6) and b["B2"] == pytest.approx(60e-6)
    assert b["collective"] == pytest.approx(100e-6) and b["library"] == pytest.approx(20e-6)
    assert b["other"] == pytest.approx(30e-6) and b["copy"] == pytest.approx(100e-6)
    # the longest gap [700, 1000] is named by the innermost op that covers most of it
    assert a["gaps"][0] == ["cudaMemcpyAsync", pytest.approx(300e-6)]
    assert a["ops"][0][0] in ("collective: ncclDevKernel_AllReduce_Sum_f32_RING_LL", "copy: Memcpy DtoH (Device -> Pageable)",
                              "B1/B3: chain_layer_kernel", "B1/B3: chain_conv5_kernel")


def test_variant_kernels_go_to_their_buckets():
    assert trace.bucket_of("void chain_layer_kernel<float, T, 32, 0, 0, false, true>(P)") == "B7"
    assert trace.bucket_of("void chain_layer_kernel<float, T, 32, 0, 0, true, false>(P)") == "B8"
    assert trace.bucket_of("void chain_layer_kernel<float, T, 32, 0, 3, false, false>(P)") == "B9"
    assert trace.bucket_of("void reduce_partials_kernel(float*)", previous="B5") == "B5"


BANNED = {"jax", "jaxlib", "flax", "selfc_tpu"}


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_under_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & BANNED, f
    # whole names: the port's name begins with the JAX package's and passes
    assert "selfc_tpu_torch".split(".")[0] not in BANNED


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH_DIR / "reference").rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(f)}
        assert "selfc_tpu_torch" not in tops and not tops & BANNED, f
