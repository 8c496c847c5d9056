"""The work of the dense chains, counted from shapes.

``chain_cost`` / ``chain_bwd_cost`` are a frozen copy of the dense chain's
cost model (operations and bytes at the chain's true growth width, only the
taps that fall inside the clip: ``(3H-2)(3W-2)`` of ``9HW`` for the four
spatial convs, ``3T-2`` of ``3T`` for the temporal conv5); ``bound_s`` the
least time the card could take for them; ``chains_work`` sums both over a
list of chain calls. Which calls a net makes, and its other products, is
its work model's (``yardstick/<name>.py``, named by the configuration
file's ``work_model``); what a unit of a driver's path counts is the
driver's (``drivers/<name>.py:work``)."""

from __future__ import annotations

from .peaks import PEAK_BYTES_PER_S, PEAK_FP32_TC


def _spatial_macs(B, T, H, W, C, gc):
    inside_hw = (3 * H - 2) * (3 * W - 2) / (9 * H * W)
    return B * T * H * W * sum(9 * (C + gc * k) * gc for k in range(4)) * inside_hw


def _chain_params(C, c_out, gc):
    return sum(9 * (C + gc * k) * gc + gc for k in range(4)) + 3 * (C + 4 * gc) * c_out + c_out


def chain_cost(B, T, H, W, C, c_out, n_aux, itemsize=4, gc=32):
    """(operations, bytes) of one whole-chain forward. Bytes: x, the
    parameters and the ``n_aux`` epilogue operands read once, the output
    written once."""
    px = B * T * H * W
    conv5 = px * 3 * (C + 4 * gc) * c_out * (3 * T - 2) / (3 * T)
    ops = 2.0 * (_spatial_macs(B, T, H, W, C, gc) + conv5)
    nbytes = itemsize * (px * (C + (1 + n_aux) * c_out) + _chain_params(C, c_out, gc))
    return ops, float(nbytes)


def chain_bwd_cost(B, T, H, W, C, itemsize=4, gc=32):
    """(operations, bytes) of the chain adjoint's four spatial layers: the
    data and the weight gradient each repeat the layer's forward products.
    Bytes: x, the saved features and the weights read once, the fp32
    gradients reaching the features and x read once, the gradient of x
    written once, the weight and bias gradients written once."""
    px = B * T * H * W
    n_params = sum(9 * (C + gc * k) * gc + gc for k in range(4))
    nbytes = itemsize * (px * (C + 4 * gc) + 2 * n_params) + 4 * px * (4 * gc + 2 * C)
    return 4.0 * _spatial_macs(B, T, H, W, C, gc), float(nbytes)


def bound_s(ops, nbytes):
    """The least time the card could take: the operations at the fp32
    tensor-core peak (3xTF32) or the bytes at the HBM bandwidth, the
    larger."""
    return max(ops / PEAK_FP32_TC, nbytes / PEAK_BYTES_PER_S)


def chains_work(chains, shape, half=None):
    """``{"chain_fwd_ops", "chain_fwd_bound_s", "chain_bwd_ops",
    "chain_bwd_bound_s"}`` of the chain calls ``chains`` (each ``(C, c_out,
    gc, n_aux, half)``, a net's work model's ``net_chains``) on the latent
    ``shape = (B, T, h, w)``: the forward and the adjoint of every call, or
    of those in ``half`` (``"encode"`` or ``"decode"``) alone. Bounds are
    summed call by call."""
    B, T, h, w = shape
    fwd_ops = fwd_bound = bwd_ops = bwd_bound = 0.0
    for C, c_out, gc, n_aux, part in chains:
        if half is not None and part != half:
            continue
        o, b = chain_cost(B, T, h, w, C, c_out, n_aux, gc=gc)
        fwd_ops += o
        fwd_bound += bound_s(o, b)
        o, b = chain_bwd_cost(B, T, h, w, C, gc=gc)
        bwd_ops += o
        bwd_bound += bound_s(o, b)
    return {"chain_fwd_ops": fwd_ops, "chain_fwd_bound_s": fwd_bound, "chain_bwd_ops": bwd_ops,
            "chain_bwd_bound_s": bwd_bound}
