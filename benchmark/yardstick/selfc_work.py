"""The work model of the SelfC nets (``SelfC_GMM``, ``SelfC_GMM_Codec``):
every dense-chain call of one encode and one decode, and the products
outside the chains, counted from the configuration file's ``scale`` and
``network_G``. The prior's widths are ``stp_hidden_c`` and
``stp_denseblock_innerc`` where ``network_G`` states them, else SelfC_GMM's
fixed 64 and 32."""

from __future__ import annotations

from .cost import chains_work

COUPLING_GC = 32


def prior_widths(cfg):
    """(hidden channels, growth) of the prior's chains."""
    net = cfg["network_G"]
    return net.get("stp_hidden_c", 64), net.get("stp_denseblock_innerc", 32)


def net_chains(cfg):
    """Every chain call of one encode plus one decode: a list of ``(C,
    c_out, gc, n_aux, half)``. A coupling block runs F (hf -> 3), H and G
    (3 -> hf) in the encode and again in the decode; the prior runs its
    first chain 3 -> hidden and then hidden -> hidden, in the decode."""
    net = cfg["network_G"]
    hf = 3 * cfg["scale"] ** 2
    hidden, gc = prior_widths(cfg)
    # F add (1 epilogue operand), H sig_exp (0), G mul_add (2)
    block = [(hf, 3, COUPLING_GC, 1), (3, hf, COUPLING_GC, 0), (3, hf, COUPLING_GC, 2)]
    chains = []
    for half in ("encode", "decode"):
        chains += [c + (half,) for c in block] * sum(net["block_num"])
    chains.append((3, hidden, gc, 0, "decode"))
    chains += [(hidden, hidden, gc, 0, "decode")] * (net["stp_blk_num"] - 1)
    return chains


def other_products(cfg, shape):
    """Multiply-adds outside the chains in one decode on the latent
    ``shape = (B, T, h, w)`` (the encode has none): the prior's pointwise
    head and each aggregation's projections (proj1 a pixel, the 1024-wide
    token pool and the two T-token projections)."""
    B, T, h, w = shape
    net = cfg["network_G"]
    hidden, _ = prior_widths(cfg)
    hf = 3 * cfg["scale"] ** 2
    px = B * T * h * w
    if net["fh_loss"] == "gmm":
        head = hidden * 2 * hidden + 2 * hidden * 4 * hidden + 4 * hidden * hf * net["gmm_k"] * 3
    else:
        head = hidden * hf
    agg = net["stp_blk_num"] * (px * hidden * hidden + B * T * (1024 * hidden + 2 * hidden * hidden))
    return px * head + agg


def roundtrip_work(cfg, shape, half=None):
    """``chains_work`` of one encode plus decode on the latent ``shape``
    (or of one ``half``), with ``ops``: the chains' forward and every other
    product (2 a multiply-add; elementwise work counts nothing)."""
    w = chains_work(net_chains(cfg), shape, half)
    other = 0.0 if half == "encode" else 2.0 * other_products(cfg, shape)
    w["ops"] = w["chain_fwd_ops"] + other
    return w
