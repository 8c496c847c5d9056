"""The 3xTF32 split of ``selfc_tpu_torch/csrc/tc_mma.cuh`` (``split_tf32``),
compiled for the CPU with the rehearsal's stand-in ``cvt.rna.tf32``
(``selfc_tpu_torch/tools/cpu_rehearsal.py``), against an independent numpy
rounding: ``hi`` is ``a`` rounded to 10 mantissa bits, to nearest with ties
away from zero, and ``hi + lo`` recovers ``a`` within 2^-21 relative (the
split's ``lo`` is itself rounded to 10 bits). B6 and B8 hold fp32 parity
only through it: one TF32 product keeps ~3 digits. Needs g++; skips
without it."""

import shutil

import numpy as np
import pytest

from selfc_tpu_torch.tools import cpu_rehearsal


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the split cannot be compiled for the CPU")
    out = tmp_path_factory.mktemp("tf32_split")
    return lambda a: cpu_rehearsal.tf32_split(a, out)


def _rna_tf32(a):
    """float32 -> tf32 in float64 arithmetic: 11 significant bits (10
    stored), the quantum of the smallest normal binade below it, to nearest
    with ties away from zero."""
    mag = np.abs(a.astype(np.float64))
    e = np.maximum(np.floor(np.log2(np.where(mag > 0, mag, 1.0))), -126)
    q = np.exp2(e - 10)
    return (np.copysign(np.floor(mag / q + 0.5) * q, a)).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


EDGES = np.array([
    0.0, -0.0, 1.0, -1.0,
    1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),             # ties: away from zero
    1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -23,  # a tie at an odd last bit; just above a tie
    np.nextafter(np.float32(2), np.float32(0)),          # rounds up into the next binade
    2.0 ** -140, 3 * 2.0 ** -149, -2.0 ** -149,          # subnormals
    np.nextafter(np.float32(2.0 ** -126), np.float32(0)),
    2.0 ** -126, 1e30, -3e38, 6.5e-30, 123456.789,       # large and small exponents
], np.float32)


def test_hi_is_the_rounded_value_with_10_mantissa_bits(split):
    rng = np.random.default_rng(0)
    a = np.concatenate([EDGES, (rng.standard_normal(4000) * np.exp2(rng.integers(-60, 60, 4000))).astype(np.float32)])
    hi, lo = split(a)
    assert np.all(_bits(hi) & 0x1FFF == 0) and np.all(_bits(lo) & 0x1FFF == 0)
    np.testing.assert_array_equal(hi, _rna_tf32(a))
    assert np.array_equal(np.signbit(hi[:2]), [False, True]) and np.all(lo[:2] == 0)
    # ties away from zero: 1 + 2^-11 -> 1 + 2^-10
    assert hi[4] == np.float32(1 + 2.0 ** -10) and hi[5] == -np.float32(1 + 2.0 ** -10)
    assert hi[8] == 2.0


def test_hi_plus_lo_recovers_a(split):
    rng = np.random.default_rng(1)
    a = np.concatenate([EDGES, (rng.standard_normal(4000) * np.exp2(rng.integers(-90, 90, 4000))).astype(np.float32)])
    hi, lo = split(a)
    a64, back = a.astype(np.float64), hi.astype(np.float64) + lo.astype(np.float64)
    normal = np.abs(a64) >= 2.0 ** -100   # lo far from the subnormal range
    assert np.all(np.abs(back - a64)[normal] <= 2.0 ** -21 * np.abs(a64)[normal])
    # below that, lo is rounded at the fixed quantum 2^-136: half of it
    assert np.all(np.abs(back - a64)[~normal] <= 2.0 ** -137)
    # one TF32 value alone keeps ~3 digits: the error 3xTF32 removes
    assert np.max(np.abs(hi.astype(np.float64) - a64)[normal] / np.abs(a64)[normal]) > 2.0 ** -13
