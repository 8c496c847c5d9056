"""``mfu.*`` (%): the whole unit's required products (counted once from the
cell's shapes by the yardstick, a training step three times its forward)
over as many units as are traced, divided by their wall time times the
fp32 tensor-core peak (165 TFLOP/s) times the cards. The wall time is
taken over those units run just before the traced ones, without the
profiler, whose own cost would count as the program's."""

from ..yardstick.peaks import PEAK_FP32_TC


def read(ctx):
    ops = ctx["work"]["ops"] * ctx["units"] * ctx["world"]
    return 100.0 * ops / (ctx["wall_s"] * PEAK_FP32_TC * ctx["world"])
