"""The traffic generator and the window statistics."""

import numpy as np
import pytest

from benchmark.harness import load_json, sub_seed
from benchmark.traffic import generate
from benchmark.yardstick import stats

BIG_SEED = 2 ** 31 + 123


def _small(name, **kw):
    mix = load_json("traffic", "mixes", f"{name}.json")
    mix.update(kw)
    return mix


def test_the_same_seed_gives_the_same_frames():
    mix = _small("gop_stream", clips=3, height=32, width=48)
    a, b = generate.clip_pool(mix, BIG_SEED, 7), generate.clip_pool(mix, BIG_SEED, 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (7, 32, 48, 3) and a[0].dtype == np.uint8
    c = generate.clip_pool(mix, BIG_SEED + 1, 7)
    assert not np.array_equal(a[0], c[0])
    packed = _small("vimeo_b8", clips=2, height=24, width=40)
    p, q = generate.packed_clips(packed, 5, 3), generate.packed_clips(packed, 5, 3)
    assert [n for n, _ in p] == ["clip000", "clip001"] and all(np.array_equal(x[1], y[1]) for x, y in zip(p, q))


def test_every_seed_serves_the_same_sizes_in_another_order():
    mix = _small("gop_stream")
    a, b = generate.request_order(mix, 1, 64), generate.request_order(mix, 2, 64)
    for order in (a, b):
        for k in range(0, 64, mix["clips"]):
            assert sorted(order[k:k + mix["clips"]]) == list(range(mix["clips"]))
    assert a != b


@pytest.mark.parametrize("name", ["gop_stream", "uvg_clips", "vimeo_b8"])
def test_a_mix_holds_only_what_is_read(name):
    mix = _small(name)
    generate.check_mix(mix)
    for bad in ({"streams": 4}, {"loop": "open"}, {"kind": "open_loop"}):
        with pytest.raises(ValueError):
            generate.check_mix({**mix, **bad})
    with pytest.raises(ValueError):
        generate.check_mix({k: v for k, v in mix.items() if k != "clips"})


def test_sub_seeds_take_large_and_negative_seeds():
    s = {sub_seed(x, 2, 5) for x in (2 ** 31 + 9, 2 ** 40, -3, 0)}
    assert len(s) == 4 and all(0 <= v < 2 ** 63 for v in s)


def _closed_loop(service_times):
    """A closed loop's window: each request starts when the last ends."""
    t, lat = 0.0, []
    for s in service_times:
        lat.append(s)
        t += s
    return stats.rate(len(lat), 0.0, t), stats.percentile(lat, 95)


def test_a_stall_inside_the_window_moves_the_rate_and_the_tail():
    steady = [0.08] * 200
    stalled = list(steady)
    for i in range(50, 62):          # twelve requests stall for 0.25 s each, 6 % of them
        stalled[i] = 0.33
    r0, p0 = _closed_loop(steady)
    r1, p1 = _closed_loop(stalled)
    assert r1 < r0 * 0.9
    assert p1 > p0 * 3


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)
    with pytest.raises(ValueError):
        stats.rate(0, 0.0, 1.0)
