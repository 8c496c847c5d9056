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

import pytest
import torch

from selfc_tpu_torch.ops import deform as df
from selfc_tpu_torch.ops import dense_chain as dc
from selfc_tpu_torch.tools import cpu_rehearsal


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
    for name, n_launches in (("dense_chain", 3), ("dense_chain_bwd", 3), ("deform", 4)):
        text, n = cpu_rehearsal.rewrite_launches((build.CSRC_DIR / f"{name}.cu").read_text())
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


def test_deform_cpu_build_counts_a_call_each_way(cpu_built):
    df.reset_launch_counts()
    with torch.no_grad():
        cpu_rehearsal.rehearse_deform(((1, 3, 4, 3, 3),), (torch.float32,))
    assert (df.launches, df.launches_bwd) == (1, 2)
    assert df.launches_by_width == {(3, 3): 1} and df.launches_bwd_by_width == {(3, 3): 2}
