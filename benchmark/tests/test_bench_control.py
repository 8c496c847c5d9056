"""On the card: each cell's control, the plain reference in TF32 put in the
program's place, fails the cell's limits, while the program passes them;
at a size a test run holds (the published nets, fewer and smaller frames).
The readings at the cells' own sizes are ``benchmark.calibrate``'s."""

import pytest

from benchmark.drivers import codec_eval, serve_gop, train_step
from benchmark.harness import Run
from benchmark.tests.tiny import SEED, correct

DRIVERS = {"gmm4x.serve.gop": serve_gop, "gmm4x.train.b8": train_step, "codec.uvg.test": codec_eval}
SMALL = {"gmm4x.serve.gop": (dict(clips=2, height=288, width=352, traced_units=2, warmup=1), None, None),
         "gmm4x.train.b8": (dict(clips=8, height=160, width=192, eps_pool=2), 4, None),
         "codec.uvg.test": (dict(clips=1, height=540, width=960, warmup=1), None, 6)}


def _run(cell, device, make=None):
    r = Run(cell, SEED, 1.0, False, device, make_program=make)
    mix, batch, frames = SMALL[cell]
    r.mix.update(mix)
    if batch:
        r.cfg["datasets"]["train"]["batch_size"] = batch
    if frames:
        r.cfg["video_len"] = frames
    return r


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(DRIVERS))
def test_the_control_fails_and_the_program_passes(card, cell):
    drv = DRIVERS[cell]
    r = _run(cell, card)
    res = drv.run(r)
    assert correct(r, res), res["checks"]
    r = _run(cell, card, drv.Control)
    res = drv.run(r)
    assert not correct(r, res), res["checks"]
