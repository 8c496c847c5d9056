"""The rest of a run without the card: each cell's driver on the CPU at a
tiny size, once as it is (``correct`` true) and once with each fault that
the cell can have planted underneath it (``correct`` false): an answer
altered where it is produced, a step that returns its state unchanged,
half of the batch left out. The limits are the cells' own, so each fault
is caught by the numbers and limits that the runs on the card use."""

import pytest

from benchmark.drivers import codec_eval, serve_gop, train_step
from benchmark.tests.tiny import correct, tiny_run

DRIVERS = {"gmm4x.serve.gop": serve_gop, "gmm4x.train.b8": train_step, "codec.uvg.test": codec_eval}
CASES = [(cell, f) for cell, drv in DRIVERS.items() for f in drv.FAULTS]


@pytest.fixture(autouse=True)
def _zlib(monkeypatch):
    monkeypatch.setenv("SELFC_TPU_DISABLE_X265", "1")


@pytest.mark.parametrize("cell", sorted(DRIVERS))
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(cell, trace):
    r = tiny_run(cell, trace)
    res = DRIVERS[cell].run(r)
    assert correct(r, res), res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        assert res["units"] > 0 and res["attr"]["window_s"] > 0
    else:
        assert all(v > 0 for v in res["e2e"].values())


@pytest.mark.parametrize("cell, fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    drv = DRIVERS[cell]
    r = tiny_run(cell)
    r.make_program = lambda run, tree: fault(drv.program(run, tree))
    res = drv.run(r)
    assert not correct(r, res), res["checks"]
