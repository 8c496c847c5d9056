"""``data_wait.*`` (%): the share of the traced steps' wall time that the
step loop spent waiting for ``next(loader)``, by the benchmark's own span
around it."""


def read(ctx):
    if ctx.get("data_wait_s") is None:
        return None
    return 100.0 * ctx["data_wait_s"] / ctx["traced_wall_s"]
