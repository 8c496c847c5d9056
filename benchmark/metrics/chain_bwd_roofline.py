"""``chain_bwd_roofline.*`` (%): the least time the card could take for the
chain adjoints the traced steps need (the four spatial layers' data and
weight gradients), over the time of the B2 bucket."""

from ..yardstick.trace import CHAIN_BWD


def read(ctx):
    spent = sum(ctx["attr"]["buckets"][b] for b in CHAIN_BWD)
    if spent <= 0 or "chain_bwd_bound_s" not in ctx["work"]:
        return None
    return 100.0 * ctx["work"]["chain_bwd_bound_s"] * ctx["units"] / spent
