"""The CUDA sources themselves (``selfc_tpu_torch/csrc/*.cu``), compiled for
the CPU by ``selfc_tpu_torch.tools.cpu_rehearsal`` (stand-in headers, a
block's threads as ``std::thread``s) and driven through the port's own launch
functions on CPU tensors, against the plain PyTorch versions.

This holds the kernels' arithmetic, indexing, edge masks and barriers in the
CPU tests; that they build with ``nvcc`` and run on the card is
``chip_smoke.py``'s business. Needs ``g++`` with C++20; skips without it.

Limits, relative to max |plain|: 1e-5 in fp32 (the same fp32 products in
another order), 3e-2 in bf16 (8 bits of mantissa, rounded at other places).
"""

import shutil

import numpy as np
import pytest
import torch

from selfc_tpu_torch.ops import deform as df
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.ops import temporal_conv as tc
from selfc_tpu_torch.tools import cpu_rehearsal
from selfc_tpu_torch.utils.bench import make_chain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes side by side, on tensors
    far too small to share out: a thread pool as wide as the machine in
    each worker only makes the workers wait for one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SHAPE = (2, 2, 9, 21)   # two clips; ragged tiles both ways (the weight gradient has 2 x 2 a frame)


@pytest.fixture(scope="module")
def cpu_built(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CUDA sources cannot be compiled for the CPU")
    with cpu_rehearsal.cpu_kernels(tmp_path_factory.mktemp("cpu_kernels")):
        yield


def _errors(rec):
    return {k: v for k, v in rec.items() if isinstance(v, float)}


def test_rewrite_finds_every_launch():
    from selfc_tpu_torch.kernels import build
    # dense_chain: conv5 (the spatial layer's launch is tc_chain.cuh's);
    # dense_chain_bwd: the top slot's dacc, the weight gradient, its
    # reduction and the data gradient; deform: the forward, and the
    # backward's maxima for the fixed point, its pass over the tiles, the
    # reduction of dW and dx's conversion; temporal_conv: the tile kernel and
    # the split-K sum
    for name, n_launches in (("dense_chain.cu", 1), ("dense_chain_bwd.cu", 4), ("deform.cu", 5),
                             ("temporal_conv.cu", 2), ("tc_chain.cuh", 1)):
        text, n = cpu_rehearsal.rewrite_launches((build.CSRC_DIR / name).read_text())
        assert n == n_launches and "<<<" not in text


@pytest.mark.parametrize("C,c_out,modes", [
    (3, 48, tuple(dc.EP_AUX)), (48, 3, ("sub_from",)), (64, 64, ("sub_mul",)), (5, 70, ("mul_add",))])
def test_cuda_sources_match_plain_fp32(cpu_built, C, c_out, modes):
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse(SHAPE, ((C, c_out),), (torch.float32,), modes)
    errs = _errors(rec)
    assert {"feats", "dx", "dw_db_need_dx_True", "dw_db_need_dx_False"} <= set(errs)
    assert all(v <= 1e-5 for v in errs.values()), errs


@pytest.mark.parametrize("C,c_out,gc,modes", [
    # the codec's prior (gc 12: 16-lane segments) and its coupling (gc 32)
    (3, 24, 12, ("none",)), (24, 24, 12, ("none", "mul_add")),
    (12, 3, 32, ("add",)), (3, 12, 32, ("sub_mul",)),
    # gc 24 pads to 32 lanes; gc 13 and 20 are not multiples of 4, so the
    # weights are staged element by element
    (24, 24, 24, ("none",)), (5, 7, 13, ("sub_mul",)), (6, 5, 20, ("add",)),
    # gc 16 fills its 16-lane segments: a full segment through the remap path
    (8, 6, 16, ("mul_add",)),
])
def test_cuda_sources_small_growth_width_fp32(cpu_built, C, c_out, gc, modes):
    """gc < 32: the forward gives what the plain version gives at the true
    gc, its feats buffer and the spatial-only forward's hold the plain
    features with zero pad lanes, and the adjoint, fed those features and a
    gradient with noise in its pad lanes, gives the plain dx, dW and db at
    the true gc."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse(SHAPE, ((C, c_out, gc),), (torch.float32,), modes)
    errs = _errors(rec)
    assert {"forward_feats", "feats", "dx", "dw_db_need_dx_True", "dw_db_need_dx_False"} <= set(errs)
    assert all(v <= 1e-5 for v in errs.values()), errs


def test_cuda_sources_small_growth_width_bf16(cpu_built):
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse(SHAPE, ((24, 24, 12),), (torch.bfloat16,), ("none", "mul_add"))
    errs = _errors(rec)
    assert "dx" in errs and all(v <= 3e-2 for v in errs.values()), rec


def test_cuda_sources_match_plain_bf16(cpu_built):
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse(SHAPE, ((3, 48),), (torch.bfloat16,), ("none", "sig_exp_neg"))
    assert all(v <= 3e-2 for v in _errors(rec).values()), rec


def test_cpu_build_counts_as_a_launch_and_is_undone(cpu_built):
    """Inside the fixture the launch functions run (and count); the plain
    wrappers are untouched, and the libraries are put back afterwards."""
    dc.reset_launch_counts()
    with torch.no_grad():
        cpu_rehearsal.rehearse((1, 1, 3, 4), ((3, 3),), (torch.float32,), ("none",))
    assert (dc.launches, dc.launches_feats, dc.launches_bwd) == (1, 1, 2)


# ---------------------------------------------------------------------------
# W-packed batches: B1, B3 and B2 with the stripe masks (stripe_w)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    # (packed shape, stripe_w, C, c_out, gc, modes): four 9-column images a
    # row (edges inside a tile and inside a thread's 8 columns), two of 18
    ((1, 2, 9, 36), 9, 3, 48, 32, tuple(dc.EP_AUX)),
    ((2, 1, 7, 36), 18, 64, 64, 32, ("sub_mul",)),
    ((1, 2, 9, 36), 9, 24, 24, 12, ("none", "mul_add")),
    ((2, 1, 7, 36), 18, 3, 24, 12, ("none",)),
], ids=["gc32_every_epilogue", "gc32_64_64", "gc12_24_24", "gc12_3_24"])
def test_cuda_sources_with_stripes_match_plain_fp32(cpu_built, case):
    """Under a stripe the forward, its feats buffer, the spatial-only
    forward and the adjoint (dx, dW, db) give what the plain versions of the
    striped calls give (unpack, run per image, pack): no tap crosses an
    image's edge, either way."""
    shape, stripe_w, C, c_out, gc, modes = case
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse(shape, ((C, c_out, gc),), (torch.float32,), modes,
                                        stripe_w=stripe_w)
    errs = _errors(rec)
    assert {"forward_feats", "feats", "dx", "dw_db_need_dx_True", "dw_db_need_dx_False"} <= set(errs)
    assert all(v <= 1e-5 for v in errs.values()), rec


def test_cuda_sources_with_stripes_match_plain_bf16(cpu_built):
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse((1, 2, 9, 36), ((48, 3, 32),), (torch.bfloat16,), ("sub_from",),
                                        stripe_w=9)
    assert "dx" in _errors(rec) and all(v <= 3e-2 for v in _errors(rec).values()), rec


def test_unpacked_launch_is_unchanged_by_the_stripe_code(cpu_built):
    """The same packed tensor without a stripe: the kernels take their
    unmasked instantiations and give the plain unstriped chain, far from
    the striped one; the striped launch is counted under its stripe."""
    rng = np.random.default_rng(3)
    x, ws, bs, w5, b5, a, _ = make_chain(rng, 3, 48, (1, 2, 9, 36), "cpu")
    dc.reset_launch_counts()
    with torch.no_grad():
        got, feats = dc._chain_cuda(x, ws, bs, w5, b5, "add", 1.0, a, None)
        striped, _ = dc._chain_cuda(x, ws, bs, w5, b5, "add", 1.0, a, None, stripe_w=9)
        g = torch.from_numpy(rng.normal(0, 1, feats.shape).astype(np.float32))
        dws, _ = dc._bwd_cuda(x, ws, bs, feats, g.clone(), None)
    want = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "add", 1.0, a)
    assert cpu_rehearsal.rel_err(got, want) <= 1e-5
    assert cpu_rehearsal.rel_err(feats, dc.chain_feats_plain(x, ws, bs)) <= 1e-5
    assert cpu_rehearsal.rel_err(dws[0], dc.chain_spatial_bwd_plain(x, ws, bs, feats, g)[1][0]) <= 1e-5
    assert cpu_rehearsal.rel_err(striped, want) > 1e-2
    assert dc.launches_by_stripe == {(3, 48, 32, 0): 1, (3, 48, 32, 9): 1}
    assert dc.launches_bwd_by_stripe == {(3, 32, 0): 1}
    with pytest.raises(ValueError, match="stripe_w"):
        dc._chain_cuda(x, ws, bs, w5, b5, "add", 1.0, a, None, stripe_w=10)


@pytest.mark.parametrize("case", [(2, 13, 21, 5, 3), (1, 9, 11, 32, 32), (1, 7, 6, 40, 36)],
                         ids=["odd", "deart_width", "over_one_slab"])
def test_deform_cuda_source_matches_plain_fp32(cpu_built, case):
    """csrc/deform.cu: the forward against the composition, the backward
    (data and weight kernels and the reduction) against the closed-form
    adjoint, offsets +-7 px and the mask in [0, 2]; dweight the same bits
    twice. The last case has C and Cout over one 32-channel slab."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_deform((case,), (torch.float32,))
    errs = _errors(rec)
    assert set(errs) == {"forward", "dx", "doffset", "dmask", "dweight"}
    assert all(v <= 1e-5 for v in errs.values()) and rec["dweight_same_bits"], rec


def test_deform_cuda_source_matches_plain_bf16(cpu_built):
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_deform(((2, 12, 16, 8, 8),), (torch.bfloat16,))
    assert all(v <= 3e-2 for v in _errors(rec).values()) and rec["dweight_same_bits"], rec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_deform_gradients_same_bits_with_blocks_reversed(cpu_built, dtype):
    """dx, doffset, dmask and dweight are the same bits when the stand-in
    launcher walks the backward's blocks last first (72 here, one a tile
    and tap): dx is summed in 64-bit fixed point, whose integer atomics give
    the same sum in any order, and dW's per-tile partials are added in a
    fixed order."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_deform(((2, 13, 21, 5, 3),), (dtype,))
    assert df._library().selfc_deform_backward_tiles(2, 13, 21) == 8
    assert rec["same_bits_blocks_reversed"] and rec["dweight_same_bits"], rec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_deform_every_offset_on_one_pixel(cpu_built, dtype):
    """Every tap of every pixel samples next to one pixel, so each of the
    four pixels around it takes 9 N H W contributions to dx (the fixed
    point's scale leaves room for 36 N H W): the backward against the
    closed-form adjoint, and the same bits with the blocks reversed."""
    limit = 1e-5 if dtype == torch.float32 else 3e-2
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_deform(((2, 6, 7, 5, 3),), (dtype,), all_to_one=True)
    errs = _errors(rec)
    assert set(errs) == {"forward", "dx", "doffset", "dmask", "dweight"}
    assert all(v <= limit for v in errs.values()) and rec["same_bits_blocks_reversed"], rec


@pytest.mark.parametrize("g_scale", [0.0, 1e20], ids=["zero", "1e20"])
def test_deform_fixed_point_scale_follows_the_gradient(cpu_built, g_scale):
    """The fixed point's exponent comes from the call's own maxima: an
    output gradient of zero gives exact zeros, one of order 1e20 (a
    negative exponent) the plain adjoint within the fp32 limit."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_deform(((1, 6, 7, 8, 8),), (torch.float32,), g_scale=g_scale)
    errs = _errors(rec)
    assert all(v <= 1e-5 for v in errs.values()) and rec["same_bits_blocks_reversed"], rec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", [(1, 5, 9, 12, 7), (1, 5, 6, 64, 64)], ids=["c12", "c64"])
def test_deform_cuda_source_channels_off_the_k_step(cpu_built, case, dtype):
    """C = 12 is not a multiple of the mma's K step (8 in fp32, 16 in bf16)
    and ends a 32-channel slab early; C = Cout = 64 (the STP prior's width)
    takes two slabs each way: forward and backward against the plain
    versions."""
    limit = 1e-5 if dtype == torch.float32 else 3e-2
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_deform((case,), (dtype,))
    errs = _errors(rec)
    assert set(errs) == {"forward", "dx", "doffset", "dmask", "dweight"}
    assert all(v <= limit for v in errs.values()) and rec["same_bits_blocks_reversed"], rec


def test_deform_one_tf32_pass_fails_the_fp32_limit(tmp_path):
    """The guard on B5's 3xTF32 splits: a copy of the sources whose products
    keep one TF32 pass puts the forward and every gradient beyond the 1e-5
    fp32 limit that the sources as they are meet."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CUDA sources cannot be compiled for the CPU")
    src = cpu_rehearsal.one_tf32_pass_sources(tmp_path / "csrc")
    with cpu_rehearsal.cpu_kernels(tmp_path / "build", src, names=["deform"]), torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_deform(((1, 9, 11, 32, 32),), (torch.float32,))
    errs = _errors(rec)
    assert set(errs) == {"forward", "dx", "doffset", "dmask", "dweight"}
    assert min(errs.values()) > 1e-5, rec


def test_deform_cpu_build_counts_a_call_each_way(cpu_built):
    df.reset_launch_counts()
    with torch.no_grad():
        cpu_rehearsal.rehearse_deform(((1, 3, 4, 3, 3),), (torch.float32,))
    assert (df.launches, df.launches_bwd) == (1, 2)
    assert df.launches_by_width == {(3, 3): 1} and df.launches_bwd_by_width == {(3, 3): 2}


@pytest.mark.parametrize("case", cpu_rehearsal.TEMPORAL_CASES,
                         ids=["ragged_hw", "one_frame", "over_one_tile", "co3"])
def test_temporal_conv_cuda_source_matches_plain_fp32(cpu_built, case):
    """csrc/temporal_conv.cu through the port's launch functions: the
    forward with no LeakyReLU, slope 0.2 and slope 0 (and the mask it writes
    there), and the data-gradient launch (flipped weights, no bias), at a
    ragged H*W, T 1 and 3, C and Co off the slab and tile sizes."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_temporal_conv((case,), (torch.float32,))
    errs = _errors(rec)
    assert set(errs) == {"forward_slope_None", "forward_slope_0.2", "forward_slope_0.0", "dx"}
    assert all(v <= 1e-5 for v in errs.values()) and rec["mask_same"], rec


def test_temporal_conv_cuda_source_matches_plain_bf16(cpu_built):
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_temporal_conv((cpu_rehearsal.TEMPORAL_CASES[2],), (torch.bfloat16,))
    assert all(v <= 3e-2 for v in _errors(rec).values()) and rec["mask_same"], rec


def test_temporal_conv_cpu_build_counts_forward_and_backward_apart(cpu_built):
    tc.reset_launch_counts()
    with torch.no_grad():
        cpu_rehearsal.rehearse_temporal_conv(((1, 3, 2, 2, 4, 5),), (torch.float32,), (None,))
    # the forward, its repeat (the same-bits check) and dx
    assert (tc.launches, tc.launches_bwd) == (2, 1)
    assert tc.launches_by_width == {(4, 5): 2} and tc.launches_bwd_by_width == {(4, 5): 1}
    assert tc.launches_by_path == {("narrow", 1): 3}


# the tile path and K split each forced case takes (the plan, for the SM count
# the case gives)
TEMPORAL_PATHS = {"narrow": ("narrow", 1), "narrow16": ("narrow", 1), "wide": ("wide", 1),
                  "narrow_split": ("narrow", 2), "wide_split": ("wide", 2), "odd_c": ("wide", 4),
                  "ragged_m": ("wide", 1), "t_over_wide_tile": ("wide", 1), "t_over_narrow_tile": ("narrow", 1)}


@pytest.mark.parametrize("name", sorted(cpu_rehearsal.TEMPORAL_PATH_CASES))
def test_temporal_conv_cuda_source_paths_fp32(cpu_built, name):
    """Every tile path of csrc/temporal_conv.cu, forced through the SM count
    the plan is given: the narrow tile (8 and 16 columns), the wide one, K
    split in parts summed by the second launch, C = 131 (4-byte copies), a
    ragged M, T over the tile's rows; forward at each slope (and the mask),
    dx, and the same bits twice."""
    tc.reset_launch_counts()
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_temporal_conv((cpu_rehearsal.TEMPORAL_PATH_CASES[name],), (torch.float32,))
    assert tuple(rec["path"]) == TEMPORAL_PATHS[name] and tuple(rec["path"]) in tc.launches_by_path
    errs = _errors(rec)
    assert set(errs) == {"forward_slope_None", "forward_slope_0.2", "forward_slope_0.0", "dx"}
    assert all(v <= 1e-5 for v in errs.values()) and rec["mask_same"] and rec["same_bits"], rec


@pytest.mark.parametrize("name", ["narrow16", "odd_c", "t_over_wide_tile"])
def test_temporal_conv_cuda_source_paths_bf16(cpu_built, name):
    """bf16 mma products; C = 131 copies 2 bytes at a time (a plain load and
    store: cp.async copies 4, 8 or 16)."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_temporal_conv((cpu_rehearsal.TEMPORAL_PATH_CASES[name],), (torch.bfloat16,))
    assert all(v <= 3e-2 for v in _errors(rec).values()) and rec["mask_same"] and rec["same_bits"], rec


# ---------------------------------------------------------------------------
# the chain variants: csrc/chain_hg.cu (B7), chain_ride.cu (B9), chain_v3.cu (B8)
# ---------------------------------------------------------------------------


def test_rewrite_finds_the_variant_launches():
    """B7's conv5 + combine, the ride's finishing launch and v3's conv5
    (their spatial layers are tc_chain.cuh's; the dynamic shared memory of
    B7's and v3's conv5 becomes static storage)."""
    from selfc_tpu_torch.kernels import build
    for name, n_launches in (("chain_hg", 1), ("chain_ride", 1), ("chain_v3", 1)):
        text, n = cpu_rehearsal.rewrite_launches((build.CSRC_DIR / f"{name}.cu").read_text())
        assert n == n_launches and "<<<" not in text and "extern __shared__" not in text


VARIANT_CASES = {
    # the pair forward and reverse at the 4x net's width and an odd one at gc 13
    "hg": dict(hg_widths=((3, 48, 32), (5, 7, 13)), ride_widths=(), v3_widths=()),
    # the ride with every epilogue at the F chain's width, c_out 10 at gc 13
    "ride": dict(hg_widths=(), ride_widths=((48, 3, 32), (5, 10, 13)), v3_widths=()),
    # v3 at the codec prior's growth 12, the 4x prior's 64->64, an odd width
    "v3": dict(hg_widths=(), ride_widths=(), v3_widths=((24, 24, 12), (64, 64, 32), (5, 7, 20))),
}


@pytest.mark.parametrize("kind", sorted(VARIANT_CASES))
def test_variant_cuda_sources_match_plain_fp32(cpu_built, kind):
    with torch.no_grad():
        recs = cpu_rehearsal.rehearse_variants(SHAPE, (torch.float32,), **VARIANT_CASES[kind])
    for rec in recs:
        errs = _errors(rec)
        assert errs and all(v <= 1e-5 for v in errs.values()), rec
    if kind == "hg":
        assert {"y2_rev_True", "se_rev_True"} <= set(_errors(recs[0]))
    if kind == "ride":
        assert {f"forward_{m}" for m in dc.EP_AUX} == set(_errors(recs[0]))


def test_v3_cuda_source_over_the_old_tile_limit(cpu_built):
    """B8 at C + 3 gc > 526, where the earlier design's halo tile of every input
    channel did not fit: the tile now holds one 16-channel slab (32 bf16)."""
    with torch.no_grad():
        recs = cpu_rehearsal.rehearse_variants((1, 2, 9, 16), (torch.float32, torch.bfloat16), hg_widths=(),
                                               ride_widths=(), v3_widths=cpu_rehearsal.V3_WIDE_C)
    assert [(r["dtype"], r["C"] + 3 * r["gc"] > 526) for r in recs] == [("float32", True), ("bfloat16", True)]
    assert recs[0]["forward"] <= 1e-5 and recs[1]["forward"] <= 3e-2, recs


def test_variant_cuda_sources_match_plain_bf16(cpu_built):
    with torch.no_grad():
        recs = cpu_rehearsal.rehearse_variants(
            SHAPE, (torch.bfloat16,), hg_widths=((3, 12, 32),), ride_widths=((12, 3, 32),),
            v3_widths=((3, 24, 12), (5, 7, 13)), modes=("sub_from", "mul_add"))
    assert len(recs) == 4 and all(all(v <= 3e-2 for v in _errors(r).values()) for r in recs), recs


def test_variant_cpu_builds_count_their_calls(cpu_built):
    from selfc_tpu_torch.ops import chain_variants as cv
    cv.reset_launch_counts()
    with torch.no_grad():
        cpu_rehearsal.rehearse_variants((1, 2, 3, 4), (torch.float32,), hg_widths=((3, 5, 32),),
                                        ride_widths=((4, 3, 12),), v3_widths=((3, 4, 8),), modes=("none",))
    assert (cv.launches_hg, cv.launches_ride, cv.launches_v3) == (2, 1, 1)
    assert cv.launches_hg_by_width == {(3, 5, 32, "forward"): 1, (3, 5, 32, "reverse"): 1}
    assert cv.launches_ride_by_width == {(4, 3, 12): 1} and cv.launches_v3_by_width == {(3, 4, 8): 1}


# ---------------------------------------------------------------------------
# the tensor-core spatial layer of B1, B3 and B9 (csrc/tc_chain.cuh)
# ---------------------------------------------------------------------------


def _seg_pads(gc):
    gcp = dc.padded_gc(gc)
    return (torch.arange(4 * gcp) % gcp) >= gc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("gc", [12, 13])
def test_feats_buffer_that_held_nan_comes_back_clean(cpu_built, gc, dtype):
    """B1's forward and B3 write every lane of their feats buffer: one filled
    with NaN before the launch comes back finite, exactly 0 in the pad lanes
    (which B1's conv5 and B2 multiply by zero weights) and the plain
    features in the real ones; B1's output, written over NaN, is the plain
    chain's."""
    rng = np.random.default_rng(gc)
    x, ws, bs, w5, b5, a, m = make_chain(rng, 5, 6, (1, 2, 7, 11), "cpu", dtype, gc)
    want = dc.padded_width(dc.chain_feats_plain(x, ws, bs), gc, dc.padded_gc(gc))
    want_out = dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 0.8, a, m)
    limit = 1e-5 if dtype == torch.float32 else 3e-2
    with torch.no_grad():
        for entry in ("forward", "feats"):
            feats = torch.full(want.shape, float("nan"), dtype=dtype)
            out = torch.full(want_out.shape, float("nan"), dtype=dtype)
            if entry == "forward":
                dc._launch_forward(x, ws, bs, w5, b5, "mul_add", 0.8, a, m, feats, out)
                assert cpu_rehearsal.rel_err(out, want_out) <= limit, entry
            else:
                dc._launch_feats(x, ws, bs, feats)
            assert torch.isfinite(feats).all() and (feats[..., _seg_pads(gc)] == 0).all(), entry
            assert cpu_rehearsal.rel_err(feats, want) <= limit, entry


def test_bf16_slab_over_two_growth_segments(cpu_built):
    """bf16 at growth 12: a 32-lane slab of the feats buffer covers two
    16-lane segments, whose weight rows are remapped lane by lane; forward,
    B3 and B2 fed from the buffer."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse((1, 2, 7, 11), ((3, 24, 12),), (torch.bfloat16,), ("sub_mul",))
    errs = _errors(rec)
    assert {"forward_feats", "feats", "dx"} <= set(errs) and all(v <= 3e-2 for v in errs.values()), rec


@pytest.mark.parametrize("shape,stripe_w", [((1, 2, 7, 48), 8), ((1, 2, 9, 48), 24)], ids=["stripe8", "stripe24"])
def test_stripe_edges_on_fragment_columns(cpu_built, shape, stripe_w):
    """Stripe edges where a fragment's 8-row halves start: at stripe 8 every
    image edge falls on column 0 or 8 of the 16-wide tile, at stripe 24 on
    column 8 (and 15 / 7 on the other side); forward, B3 and B2 fed from the
    buffer, held to the plain striped calls."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse(shape, ((3, 48, 32), ), (torch.float32,), ("add",), stripe_w=stripe_w)
    errs = _errors(rec)
    assert {"forward_add", "feats", "dx", "dw_db_need_dx_True"} <= set(errs)
    assert all(v <= 1e-5 for v in errs.values()), rec


@pytest.mark.parametrize("c_out", [1, 10])
def test_ride_narrowest_and_widest_c_out(cpu_built, c_out):
    """The ride at one output column (its N padded 1 -> 16) and at the
    widest it takes (3 x 10 -> 32), with every epilogue."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_variants((1, 2, 7, 11), (torch.float32,), hg_widths=(),
                                                 ride_widths=((6, c_out, 20),), v3_widths=())
    assert {f"forward_{m}" for m in dc.EP_AUX} == set(_errors(rec))
    assert all(v <= 1e-5 for v in _errors(rec).values()), rec


@pytest.mark.parametrize("shape", [(1, 2, 7, 17), (1, 2, 9, 21)], ids=["7x17", "9x21"])
def test_odd_sizes_and_same_bits_twice(cpu_built, shape):
    """The layer's 8 x 16 tile at odd sizes (ragged tiles both ways, one
    frame row short of a tile and one over): B1's forward, B3 and B9
    against their plain versions, each the same bits twice."""
    from selfc_tpu_torch.ops import chain_variants as cv
    rng = np.random.default_rng(7)
    x, ws, bs, w5, b5, a, m = make_chain(rng, 6, 3, shape, "cpu", gc=20)
    with torch.no_grad():
        runs = {"forward": lambda: dc._chain_cuda(x, ws, bs, w5, b5, "mul_add", 0.8, a, m)[0],
                "feats": lambda: dc._feats_cuda(x, ws, bs),
                "ride": lambda: cv._ride_cuda(x, ws, bs, w5, b5, "mul_add", 0.8, a, m)}
        wants = {"forward": dc.dense_chain_t_ep_plain(x, ws, bs, w5, b5, "mul_add", 0.8, a, m),
                 "feats": dc.padded_width(dc.chain_feats_plain(x, ws, bs), 20, 32)}
        wants["ride"] = wants["forward"]
        for name, run in runs.items():
            got = run()
            assert cpu_rehearsal.rel_err(got, wants[name]) <= 1e-5, name
            assert torch.equal(got, run()), name


def test_one_tf32_pass_fails_the_fp32_limit(tmp_path):
    """The guard on the 3xTF32 splits: a copy of the sources whose products
    keep one TF32 pass (each operand's low part zeroed, in both splits) puts
    B3's features beyond the 1e-5 fp32 limit and the adjoint's (B2's) dx, dW
    and db beyond 1e-4 of max |plain| (chip_smoke.py's fp32 limit for the
    adjoint), which the sources as they are meet (the rehearsal reads a TF32
    operand as its 19 bits, as the card does)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the CUDA sources cannot be compiled for the CPU")
    rng = np.random.default_rng(11)
    x, ws, bs, *_ = make_chain(rng, 8, 3, (1, 1, 5, 9), "cpu")
    want = dc.chain_feats_plain(x, ws, bs)
    src = cpu_rehearsal.one_tf32_pass_sources(tmp_path / "csrc")
    with cpu_rehearsal.cpu_kernels(tmp_path / "build", src, names=["dense_chain", "dense_chain_bwd"]), torch.no_grad():
        err = cpu_rehearsal.rel_err(dc._feats_cuda(x, ws, bs), want)
        (rec,) = cpu_rehearsal.rehearse_bwd((1, 1, 5, 9), ((8, 32),), (torch.float32,))
    assert err > 1e-5, err
    assert min(_errors(rec).values()) > 1e-4, rec


# ---------------------------------------------------------------------------
# B2 (csrc/dense_chain_bwd.cu) and B7 (csrc/chain_hg.cu) on the tensor cores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,stripe", [(torch.float32, 0), (torch.bfloat16, 1)], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,gc", [(3, 32), (24, 12), (5, 13)], ids=["gc32", "gc12", "gc13"])
def test_chain_bwd_stripe_edges_on_fragment_columns(cpu_built, C, gc, dtype, stripe):
    """B2 alone under stripe 8 (fp32) and 24 (bf16), whose image edges fall
    where a fragment's 8-pixel halves start (the data gradient's rows, the
    weight gradient's k columns): dx, dW and db against the plain adjoint of
    the striped call, fed a gradient with noise in its pad lanes, and the
    same bits twice. gc 13 stages its weight rows element by element."""
    limit = 1e-5 if dtype == torch.float32 else 3e-2
    shape, sw = cpu_rehearsal.BWD_STRIPE_CASES[stripe]
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_bwd(shape, ((C, gc),), (dtype,), stripe_w=sw)
    errs = _errors(rec)
    assert set(errs) == {"dx", "dw", "db"} and all(v <= limit for v in errs.values()) and rec["same_bits"], rec


@pytest.mark.parametrize("C,c_out,gc", [(3, 48, 32), (5, 7, 13)], ids=["3_48_32", "odd_5_7_13"])
def test_hg_cuda_source_bf16(cpu_built, C, c_out, gc):
    """B7 in bf16, forward and reverse combine, at the 4x pair's width and an
    odd one (gc 13: 16-lane segments; c_out 7 on conv5's narrow tile)."""
    with torch.no_grad():
        (rec,) = cpu_rehearsal.rehearse_variants((1, 2, 7, 11), (torch.bfloat16,), hg_widths=((C, c_out, gc),),
                                                 ride_widths=(), v3_widths=())
    errs = _errors(rec)
    assert {"y2_rev_False", "y2_rev_True", "se_rev_False", "se_rev_True"} == set(errs)
    assert all(v <= 3e-2 for v in errs.values()), rec

