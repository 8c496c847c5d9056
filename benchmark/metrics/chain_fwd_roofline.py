"""``chain_fwd_roofline.*`` (%): the least time the card could take for the
chain forwards the traced units need (each call's operations at 165
TFLOP/s or its bytes at 3.35 TB/s, the larger), over the time of the
kernels that compute them (the B1/B3 bucket and the chain variants')."""

from ..yardstick.trace import CHAIN_FWD


def read(ctx):
    spent = sum(ctx["attr"]["buckets"][b] for b in CHAIN_FWD)
    if spent <= 0:
        return None
    return 100.0 * ctx["work"]["chain_fwd_bound_s"] * ctx["units"] / spent
