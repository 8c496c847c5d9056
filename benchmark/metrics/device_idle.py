"""``device_idle.*`` (%): the share of the units' wall time in which the
device ran no operation: 1 minus the union of the device's operations
(kernels, copies, sets) over the traced units, divided by the wall time of
as many units run just before them without the profiler; the mean over
the ranks. The profiler slows the host's launches and not the device's
operations, so the traced window's own idle share (the result line's
``busy_s`` over ``window_s``) holds the profiler's cost besides."""


def read(ctx):
    busy = [a["busy_s"] for a in ctx["attrs"] if a["busy_s"]]
    if not busy or not ctx["wall_s"]:
        return None
    return 100.0 * (1.0 - sum(busy) / len(busy) / ctx["wall_s"])
