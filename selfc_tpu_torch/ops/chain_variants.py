"""The opt-in schedules of the D2DT dense chain: the H/G pair (B7), conv5
riding the spatial layers (B9) and the taps folded into the contraction (B8).

Replaces, of ``selfc_tpu/ops/pallas_chain.py``: ``_hg_kernel`` (through
``_pallas_impl_hg`` / ``fused_hg_pair``, opted in there by
``SELFC_TPU_PALLAS_HG=1``), ``_chain_kernel_v2r`` (through
``_pallas_impl_v2r``, ``SELFC_TPU_PALLAS_RIDE=1``) and ``_chain_kernel_v3``
(through ``_pallas_impl_v3``, ``SELFC_TPU_PALLAS_V3=1``). The port selects
them with ``network_G.chain_variants``, a list out of ``VARIANTS``; the nets
hand it to every ``InvBlockExp`` and ``DenseChain`` (``models/blocks.py``,
``models/coupling.py``), which route a chain with ``pick`` as the JAX package
routes it (``_fused_chain_ep.prim``, ``_impl_best``).

All three compute functions B1 (``ops/dense_chain.py``) already computes, so
the plain versions of B8 and B9 are B1's ``dense_chain_t_ep_plain``; B7's is
``fused_hg_pair_plain``, two chains and the y2 combine. On a CUDA tensor the
wrappers launch the hand-written kernels of ``csrc/chain_hg.cu``,
``csrc/chain_ride.cu`` and ``csrc/chain_v3.cu`` or raise; on a CPU tensor they
run the plain versions, and only there. The TPU's layout gates
(``hg_shapes_ok``, ``chain_v3_shapes_ok``, ``W % 16`` in ``ride_ok``, the VMEM
budgets) are left out, as for B1: the Hopper kernels take any B, T, H, W. The
gates that are part of the design stay: ``c_out <= 10`` for the ride, and the
pair only for subnets with the fused epilogues.

W-packing (``network_G.pack_w``, on by default as in the JAX package) meets
the variants as it does there. Under a stripe (the coupling chain packed
once, ``models/inv_nets.py``) only B1 runs, with its stripe masks: no ride,
no v3 (JAX ``_fused_chain_ep.prim``), and the pair is refused
(``models/coupling.py``: it has no masks; the nets do not pack with "hg").
Outside a stripe a chain tries v3 (no epilogue), then the ride, then a
packed B1 (P > 1), then B1. The route at the training latent W = 36
(P = 4), the port's and the JAX package's:

  ====================================  ==========  ===================================
  chain                                  port        JAX package
  ====================================  ==========  ===================================
  coupling chain packed once (no "hg")   B1 + masks  B1 + masks
  F with "hg" and "ride" (c_out 3)       ride        packed B1 (``ride_ok``'s W % 16)
  no epilogue (the prior), "v3"          v3          packed B1 (``chain_v3_shapes_ok``)
  no epilogue, otherwise                 packed B1   packed B1
  ====================================  ==========  ===================================

The two rows that differ compute the same function: the port keeps the
decision of dropping the TPU's W gates.

Gradients, as the JAX package takes them: a chain that took B8 or B9 keeps no
features, and its backward recomputes them with B3 and runs B2 (the
``save_feats=False`` route of ``dense_chain_t_ep``). The pair is an
``autograd.Function`` (``_HGPair``) whose backward recomputes both chains'
features with B3, takes the combine's and conv5's adjoints as elementwise
and ``torch.matmul`` glue, and runs B2 once a chain.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..kernels import build
from . import dense_chain as dc
from . import temporal_conv as tc
from .conv import temporal_conv3

VARIANTS = ("hg", "ride", "v3")
RIDE_MAX_C_OUT = 10   # conv5 rides the spatial layers only this narrow

# calls that went to the CUDA kernels (one a call, five launches inside), in
# all and by width: the pair by (C, c_out, gc, "forward" | "reverse"), the
# ride and v3 chains by (C, c_out, gc)
launches_hg = 0
launches_hg_by_width: dict = {}
launches_ride = 0
launches_ride_by_width: dict = {}
launches_v3 = 0
launches_v3_by_width: dict = {}


def reset_launch_counts():
    global launches_hg, launches_ride, launches_v3
    launches_hg = launches_ride = launches_v3 = 0
    for d in (launches_hg_by_width, launches_ride_by_width, launches_v3_by_width):
        d.clear()


def parse_variants(names) -> frozenset:
    """``network_G.chain_variants`` -> the set of variant names; empty (or
    None) keeps every chain on B1. An unknown name raises."""
    if names is None:
        return frozenset()
    if isinstance(names, str):
        raise ValueError(f"chain_variants: expected a list of names out of {VARIANTS}, got {names!r}")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"chain_variants: unknown {unknown}; known: {list(VARIANTS)}")
    return frozenset(names)


def pick(variants, mode, c_out, stripe=0, P=1) -> str:
    """The schedule of one chain: "ride", "v3", "pack" (B1 on the batch
    W-packed P to a row) or "v2" (B1; under a ``stripe``, with its masks).
    Under a stripe only B1 runs (JAX ``_fused_chain_ep.prim``). Otherwise a
    chain with an epilogue rides when "ride" is on and c_out <= 10, one
    without tries v3, then the ride (JAX ``_impl_best``); then P > 1 (the
    caller's ``pick_pack_w``, 1 with packing off) packs. The H/G pair is the
    coupling's choice (``models/coupling.py``)."""
    if stripe:
        return "v2"
    if mode == "none" and "v3" in variants:
        return "v3"
    if "ride" in variants and c_out <= RIDE_MAX_C_OUT:
        return "ride"
    return "pack" if P > 1 else "v2"


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

# B9 and B8 compute B1's function: their plain version is B1's
dense_chain_ride_plain = dc.dense_chain_t_ep_plain
dense_chain_v3_plain = dc.dense_chain_t_ep_plain


def _conv5_acc(x, feats, w5, b5):
    """conv5 over ``[x | feats]`` in fp32 (fp64 for fp64 input)."""
    acc = dc._acc_dtype(x)
    gc = (w5.shape[1] - x.shape[-1]) // 4
    cat = torch.cat([x, dc.true_width(feats, gc)], dim=-1).to(acc)
    return temporal_conv3(cat, w5.to(acc), b5.to(acc))


def _combine(h5, g5, x2, clamp, rev):
    """(y2, se) from the two chains' conv5 outputs, in their dtype."""
    se = torch.exp((-clamp if rev else clamp) * (2.0 * torch.sigmoid(h5) - 1.0))
    return ((x2 - g5) * se if rev else x2 * se + g5), se


def fused_hg_pair_plain(x, x2, hws, hbs, hw5, hb5, gws, gbs, gw5, gb5, clamp, rev):
    """Plain version of the pair (JAX ``_xla_hg``), differentiable by
    autograd: ``(y2, exp(+-s))`` with ``s = clamp*(2 sigmoid(H(x)) - 1)``;
    y2 = x2 exp(s) + G(x) forward, (x2 - G(x)) exp(-s) reverse. conv5 and
    the combine run in fp32 and the results return in x's dtype, as in the
    kernel."""
    h5 = _conv5_acc(x, dc.chain_feats_plain(x, hws, hbs), hw5, hb5)
    g5 = _conv5_acc(x, dc.chain_feats_plain(x, gws, gbs), gw5, gb5)
    y2, se = _combine(h5, g5, x2.to(h5.dtype), clamp, rev)
    return y2.to(x.dtype), se.to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _library(name):
    """A kernel library, its C signatures set at the first call."""
    lib = build.load(name)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "chain_hg" and lib.selfc_chain_hg_forward.argtypes is None:
        lib.selfc_chain_hg_forward.argtypes = [P] * 26 + [I] * 7 + [Fl, I, I, P]
        lib.selfc_chain_hg_forward.restype = I
        lib.selfc_chain_hg_padded_gc.argtypes = [I]
        lib.selfc_chain_hg_padded_gc.restype = I
        lib.selfc_hg_cuda_error_string.argtypes = [I]
        lib.selfc_hg_cuda_error_string.restype = ctypes.c_char_p
    if name == "chain_ride" and lib.selfc_chain_ride_forward.argtypes is None:
        lib.selfc_chain_ride_forward.argtypes = [P] * 16 + [I] * 8 + [Fl, I, P]
        lib.selfc_chain_ride_forward.restype = I
        lib.selfc_chain_ride_padded_gc.argtypes = [I]
        lib.selfc_chain_ride_padded_gc.restype = I
        lib.selfc_chain_ride_max_c_out.argtypes = []
        lib.selfc_chain_ride_max_c_out.restype = I
        lib.selfc_ride_cuda_error_string.argtypes = [I]
        lib.selfc_ride_cuda_error_string.restype = ctypes.c_char_p
    if name == "chain_v3" and lib.selfc_chain_v3_forward.argtypes is None:
        lib.selfc_chain_v3_forward.argtypes = [P] * 13 + [I] * 8 + [P]
        lib.selfc_chain_v3_forward.restype = I
        lib.selfc_v3_cuda_error_string.argtypes = [I]
        lib.selfc_v3_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _stream(x):
    """PyTorch's current stream on x's device, as an integer handle."""
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def _hg_cuda(x, x2, hws, hbs, hw5, hb5, gws, gbs, gw5, gb5, clamp, rev):
    """The pair's kernels: ``(y2, se)``. Raises on anything they do not take."""
    global launches_hg
    dc._validate(x, hws, hbs, hw5, hb5, "none", None, None)
    dc._validate(x, gws, gbs, gw5, gb5, "none", None, None)
    B, T, H, W, C = x.shape
    gc, c_out = hws[0].shape[-1], hw5.shape[-1]
    if gws[0].shape[-1] != gc or gw5.shape[-1] != c_out:
        raise ValueError("the H and G chains of a pair must have one growth width and one c_out")
    dc._check("x2", x2, (B, T, H, W, c_out), x)
    if 2 * B * T > 65535:
        raise ValueError(f"2*B*T = {2 * B * T} exceeds the kernel's grid limit 65535")
    lib = _library("chain_hg")
    gcp = lib.selfc_chain_hg_padded_gc(gc)
    feats = torch.empty((2, B, T, H, W, 4 * gcp), dtype=x.dtype, device=x.device)
    y2 = torch.empty((B, T, H, W, c_out), dtype=x.dtype, device=x.device)
    se = torch.empty_like(y2)
    err = lib.selfc_chain_hg_forward(
        x.data_ptr(), x2.data_ptr(), *_ptrs(hws), *_ptrs(hbs), hw5.data_ptr(), hb5.data_ptr(),
        *_ptrs(gws), *_ptrs(gbs), gw5.data_ptr(), gb5.data_ptr(), feats[0].data_ptr(),
        feats[1].data_ptr(), y2.data_ptr(), se.data_ptr(), B * T, T, H, W, C, gc, c_out,
        float(clamp), int(bool(rev)), dc._DTYPE_CODE[x.dtype], _stream(x))
    dc._raise_on(err, "H/G pair", lib.selfc_hg_cuda_error_string)
    launches_hg += 1
    dc._count((C, c_out, gc, "reverse" if rev else "forward"), launches_hg_by_width)
    return y2, se


def _ride_cuda(x, ws, bs, w5, b5, mode, clamp, a, m):
    """The ride's kernels: the chain's output (no features are kept)."""
    global launches_ride
    dc._validate(x, ws, bs, w5, b5, mode, a, m)
    B, T, H, W, C = x.shape
    gc, c_out = ws[0].shape[-1], w5.shape[-1]
    lib = _library("chain_ride")
    if c_out > lib.selfc_chain_ride_max_c_out():
        raise ValueError(f"c_out {c_out}: conv5 rides the spatial layers up to {RIDE_MAX_C_OUT} outputs")
    n_aux = dc.EP_AUX[mode]
    feats = torch.empty((B, T, H, W, 3 * lib.selfc_chain_ride_padded_gc(gc)), dtype=x.dtype, device=x.device)
    partial = torch.empty((3, B * T * H * W * c_out), dtype=torch.float32, device=x.device)
    out = torch.empty((B, T, H, W, c_out), dtype=x.dtype, device=x.device)
    err = lib.selfc_chain_ride_forward(
        x.data_ptr(), *_ptrs(ws), *_ptrs(bs), w5.data_ptr(), b5.data_ptr(),
        a.data_ptr() if n_aux >= 1 else None, m.data_ptr() if n_aux >= 2 else None,
        feats.data_ptr(), partial.data_ptr(), out.data_ptr(), B * T, T, H, W, C, gc, c_out,
        dc._EP_CODE[mode], float(clamp), dc._DTYPE_CODE[x.dtype], _stream(x))
    dc._raise_on(err, "ride chain", lib.selfc_ride_cuda_error_string)
    launches_ride += 1
    dc._count((C, c_out, gc), launches_ride_by_width)
    return out


def _v3_cuda(x, ws, bs, w5, b5, mode="none", clamp=1.0, a=None, m=None):
    """The v3 kernels: the chain's output without an epilogue (no features
    are kept)."""
    global launches_v3
    if mode != "none":
        raise ValueError(f"the v3 chain takes no epilogue, got {mode!r}")
    dc._validate(x, ws, bs, w5, b5, mode, a, m)
    B, T, H, W, C = x.shape
    gc, c_out = ws[0].shape[-1], w5.shape[-1]
    lib = _library("chain_v3")
    feats = torch.empty((B, T, H, W, 4 * gc), dtype=x.dtype, device=x.device)
    out = torch.empty((B, T, H, W, c_out), dtype=x.dtype, device=x.device)
    err = lib.selfc_chain_v3_forward(
        x.data_ptr(), *_ptrs(ws), *_ptrs(bs), w5.data_ptr(), b5.data_ptr(), feats.data_ptr(),
        out.data_ptr(), B * T, T, H, W, C, gc, c_out, dc._DTYPE_CODE[x.dtype], _stream(x))
    dc._raise_on(err, "v3 chain", lib.selfc_v3_cuda_error_string)
    launches_v3 += 1
    dc._count((C, c_out, gc), launches_v3_by_width)
    return out


# ---------------------------------------------------------------------------
# wrappers: a CUDA tensor goes to the kernels or raises, a CPU tensor to the
# plain version
# ---------------------------------------------------------------------------


def dense_chain_ride(x, ws, bs, w5, b5, mode="none", clamp=1.0, a=None, m=None):
    """The chain through B9 (c_out <= 10), differentiable: the backward
    recomputes the features with B3 and runs B2."""
    if w5.shape[-1] > RIDE_MAX_C_OUT:
        raise ValueError(f"c_out {w5.shape[-1]}: conv5 rides the spatial layers up to {RIDE_MAX_C_OUT} outputs")
    return dc.dense_chain_t_ep(x, ws, bs, w5, b5, mode, clamp, a, m, save_feats=False, launch=_ride_cuda)


def dense_chain_v3(x, ws, bs, w5, b5):
    """The chain without an epilogue through B8, differentiable: the
    backward recomputes the features with B3 and runs B2."""
    return dc.dense_chain_t_ep(x, ws, bs, w5, b5, "none", 1.0, save_feats=False, launch=_v3_cuda)


class _HGPair(torch.autograd.Function):
    """``fused_hg_pair`` on tensors already cast to x's dtype. Backward: (1)
    both chains' features again (B3 on a CUDA tensor); (2) the combine's
    adjoint, elementwise in fp32 (the reverse recomputes G's conv5 for
    x2 - g5, through B6 on a CUDA tensor); (3) each chain's conv5 adjoint as
    plain products; (4) each chain's spatial adjoint (B2), both adding into
    one fp32 dx."""

    @staticmethod
    def forward(ctx, clamp, rev, x, x2, *params):
        hws, hbs, hw5, hb5 = params[0:4], params[4:8], params[8], params[9]
        gws, gbs, gw5, gb5 = params[10:14], params[14:18], params[18], params[19]
        if x.is_cuda:
            y2, se = _hg_cuda(x, x2, hws, hbs, hw5, hb5, gws, gbs, gw5, gb5, clamp, rev)
        else:
            y2, se = fused_hg_pair_plain(x, x2, hws, hbs, hw5, hb5, gws, gbs, gw5, gb5, clamp, rev)
        ctx.clamp, ctx.rev = clamp, rev
        ctx.save_for_backward(x, x2, se, *params)
        return y2, se

    @staticmethod
    @once_differentiable
    def backward(ctx, g_y2, g_se):
        x, x2, se, *params = ctx.saved_tensors
        return (None, None, *hg_adjoint(x, x2, se, params, g_y2, g_se, ctx.clamp, ctx.rev))


def hg_adjoint(x, x2, se, params, g_y2, g_se, clamp, rev, feats=None, plain=False):
    """The pair's gradient ``(dx, dx2, *dparams)`` (params in
    ``_HGPair``'s order) for the output gradients ``g_y2``, ``g_se``.
    ``feats``: the two chains' features (their device's layout), recomputed
    when None. ``plain``: take the plain adjoints on a CUDA tensor too (to
    hold the kernels' route against them at the same features)."""
    chains = ((params[0:4], params[4:8], params[8], params[9]),
              (params[10:14], params[14:18], params[18], params[19]))
    acc = dc._acc_dtype(x)
    if feats is None:
        feats = [dc.chain_feats(x, list(ws), list(bs)) for ws, bs, _, _ in chains]
    kernels = x.is_cuda and not plain
    s, gy, gs, xa = se.to(acc), g_y2.to(acc), g_se.to(acc), x2.to(acc)
    dx2 = gy * s
    if rev:
        gws, _, gw5, gb5 = chains[1]
        conv5 = tc.temporal_conv3_fused if kernels else tc.temporal_conv3_fused_plain
        g5 = conv5(torch.cat([x, dc.true_width(feats[1], gws[0].shape[-1])], dim=-1), gw5, gb5).to(acc)
        dse, dg5 = gy * (xa - g5) + gs, -dx2
    else:
        dse, dg5 = gy * xa + gs, gy
    # se = exp(+-c t), t = 2 sigmoid(h5) - 1 = +-log(se)/c, dt/dh5 = (1 - t^2)/2
    sign = -1.0 if rev else 1.0
    dh5 = dse * s * (sign * clamp * 0.5) * (1.0 - (torch.log(s) / clamp) ** 2)
    dx = None
    grads = []
    for (ws, bs, w5, b5), f, dy5 in zip(chains, feats, (dh5, dg5)):
        dw5, db5, dfeats, dxd = dc._conv5_adjoint(x, f, w5, dy5.contiguous(), True)
        dx = dxd if dx is None else dx + dxd
        if kernels:
            dws, dbs = dc._bwd_cuda(x, list(ws), list(bs), f, dfeats, dx)
        else:
            dx, dws, dbs = dc.chain_spatial_bwd_plain(x, list(ws), list(bs), f, dfeats, dx)
            dx = dx.to(acc)
        grads.append((dws, dbs, dw5.to(w5.dtype), db5.to(b5.dtype)))
    (hdws, hdbs, hdw5, hdb5), (gdws, gdbs, gdw5, gdb5) = grads
    return (dx.to(x.dtype), dx2.to(x2.dtype), *hdws, *hdbs, hdw5, hdb5, *gdws, *gdbs, gdw5, gdb5)


def fused_hg_pair(x, x2, hws, hbs, hw5, hb5, gws, gbs, gw5, gb5, clamp, rev):
    """Both coupling subnets H and G on their shared input x and the y2
    combine, differentiable (the JAX signature and layout): ``(y2,
    exp(+-s))``. A CUDA tensor goes to B7 (or raises), a CPU tensor to the
    plain version. Parameters and x2 are cast to x's dtype first, outside
    the autograd function, as in ``dense_chain_t_ep``."""
    dt = x.dtype
    cast = lambda ts: [t.to(dt) for t in ts]  # noqa: E731
    return _HGPair.apply(float(clamp), bool(rev), x, x2.to(dt).contiguous(),
                         *cast(hws), *cast(hbs), hw5.to(dt), hb5.to(dt),
                         *cast(gws), *cast(gbs), gw5.to(dt), gb5.to(dt))
