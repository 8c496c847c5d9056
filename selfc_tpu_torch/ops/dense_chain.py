"""The D2DT dense chain with a fused coupling epilogue, and its gradient.

Replaces, of ``selfc_tpu/ops/pallas_chain.py``: ``_chain_kernel_v2`` (the
forward, reached there through ``fused_dense_chain_t_ep``; its ``emit_feats``
output is the feats buffer kept here for the backward), ``_pallas_feats``
(the spatial-only forward), ``_chain_bwd_kernel`` (the adjoint of the four
spatial convs, reached through ``_pallas_bwd``) and ``_chain_kernel`` (the
v1 spatial chain behind ``fused_dense_spatial``, whose conv5 runs outside:
here a route over the spatial-only forward and the adjoint).

The function, on a channels-last video ``x (B,T,H,W,C)``:

  x_k = lrelu_0.2(conv3x3_SAME([x | x_1 .. x_{k-1}], w_k) + b_k),  k = 1..4
  y5  = temporal_conv3([x | x_1..x_4], w5) + b5          (zero pad in T)
  out = ep_apply(y5, mode, clamp, a, m)                  (in fp32)

with ``w_k (3,3,C+gc(k-1),gc)``, ``w5 (3,C+4gc,c_out)`` and the epilogue
operands ``a``, ``m`` of the output's shape; the growth width ``gc`` is 32
in the coupling and the 4x prior, 12 in the codec's prior. ``feats`` below is
the concat ``[x_1 | .. | x_4]`` of shape ``(B,T,H,W,4gc)``.

On a CUDA tensor the work is done by the hand-written kernels of
``csrc/dense_chain.cu`` (forward, spatial-only forward) and
``csrc/dense_chain_bwd.cu`` (adjoint). The chain is bound by arithmetic on
the card, not by bytes (a 64->64 chain does ~331k operations for each pixel
and moves under 1 KB of it), so the kernels trade device memory for
arithmetic: five launches write x_1..x_4 into channel slices of one
preallocated ``(B,T,H,W,4*GCP)`` buffer (the concat is never assembled and
no halo is recomputed). The forward's products run on the tensor cores
(``csrc/tc_chain.cuh``, ``csrc/tc_mma.cuh``): 3xTF32 for fp32, which keeps
fp32 accuracy, bf16 mma for bf16, sums in fp32, on 8 x 16-pixel spatial
tiles; the epilogue is applied where conv5's accumulator lives.
``GCP = padded_gc(gc)`` is gc
rounded up to 16 or 32: every kernel takes any gc in 1..32 and remaps the
weights while staging them (a growth segment's pad lanes meet zero
weights), without a padded weight copy. The adjoint keeps the same layout:
the running gradient is an fp32 ``dx (…,C)`` / ``dfeats (…,4*GCP)`` pair in
device memory, swept k = 4..1 by one data-gradient and one weight-gradient
launch a layer, the latter reduced over blocks in a fixed order (the same
bits on every run); dW and db come out at the true gc. The adjoint's
products run on the tensor cores too (3xTF32, fp32 sums, in both dtypes:
bf16 tensors are widened as they are staged, dW and db rounded once).

Feature layouts: a feats tensor holds its four growth segments side by side,
``P >= gc`` lanes each with the first gc real. The plain versions write
``P = gc``; the kernels write ``P = padded_gc(gc)`` with zero pad lanes.
``chain_feats`` returns its device's layout, and ``chain_spatial_bwd`` and
``_conv5_adjoint`` take either (P is read off the shape).

``dense_chain_t_ep`` and ``fused_dense_spatial`` are differentiable on both
devices through a ``torch.autograd.Function`` each: the kernels on a CUDA
tensor, the plain PyTorch versions below on a CPU tensor, and only there.

W-packing (JAX ``_pick_pack_w`` / ``_pack_w`` / ``stripe_w``): a batch of
narrow images is laid side by side along W, ``(B,T,H,W,C) ->
(B/P,T,H,P*W,C)``, so that the kernels' tiles cover fewer pad columns
(the adjoint's 16x16 tiles: 3x9 over 48x144 for four 36x36 images, 75 %
full, against 3x3 over 48x48 each, 56 %; the forward's 8 x 16 tiles 90 %
full against 68 %). B1, B3 and B2 then take ``stripe_w = W`` and mask
every 3x3 tap that would cross from one image into the next; conv5 and the
epilogues are temporal and pointwise and need nothing. ``dense_chain_t_ep``
takes inputs that arrive packed (``stripe``, the coupling chain packs once,
``models/inv_nets.py``) or packs a call itself (``pack``). The plain version
of a striped call unpacks, runs the per-image plain chain and packs again:
it does not depend on the masks.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..kernels import build
from . import temporal_conv as tc
from .conv import temporal_conv3

GC_MAX = 32  # the widest growth the CUDA kernels take

# number of auxiliary operands of each epilogue
#   add          y = a + y5            (fwd y1 = x1 + F(x2))
#   sub_from     y = a - y5            (rev y1 = x1 - F(y2))
#   sig_exp      y = exp(+c*(2sig-1))  (fwd scale exp(s) from H)
#   sig_exp_neg  y = exp(-c*(2sig-1))  (rev scale exp(-s) from H)
#   mul_add      y = a*m + y5          (fwd y2 = x2*exp(s) + G(y1))
#   sub_mul      y = (a - y5)*m        (rev y2 = (x2 - G(x1))*exp(-s))
EP_AUX = {"none": 0, "sig_exp": 0, "sig_exp_neg": 0, "add": 1,
          "sub_from": 1, "mul_add": 2, "sub_mul": 2}
_EP_CODE = {"none": 0, "add": 1, "sub_from": 2, "sig_exp": 3,
            "sig_exp_neg": 4, "mul_add": 5, "sub_mul": 6}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# blocks of one weight-gradient launch (shared among a layer's chunks), each
# with a partial sum of its own: two for each of the card's 132 multiprocessors
BWD_GROUPS = 264

# calls that went to the CUDA kernels (one per call, whatever number of
# launches the call makes inside), in all and by width: the forward chain by
# (C, c_out, gc); the chain adjoint and the spatial-only forward, whose work
# does not depend on c_out, by (C, gc); the v1 spatial chain
# (``fused_dense_spatial``) forward and backward by (C, gc), each of its calls
# also counted as the spatial-only forward or adjoint launch it makes
launches = 0
launches_by_width: dict = {}
launches_bwd = 0
launches_bwd_by_width: dict = {}
launches_feats = 0
launches_feats_by_width: dict = {}
launches_spatial = 0
launches_spatial_by_width: dict = {}
launches_spatial_bwd = 0
launches_spatial_bwd_by_width: dict = {}
# the same calls of the forward chain, the adjoint and the spatial-only
# forward by width and stripe (0: not W-packed): (C, c_out, gc, stripe_w) and
# (C, gc, stripe_w)
launches_by_stripe: dict = {}
launches_bwd_by_stripe: dict = {}
launches_feats_by_stripe: dict = {}


def reset_launch_counts():
    global launches, launches_bwd, launches_feats, launches_spatial, launches_spatial_bwd
    launches = launches_bwd = launches_feats = launches_spatial = launches_spatial_bwd = 0
    for d in (launches_by_width, launches_bwd_by_width, launches_feats_by_width,
              launches_spatial_by_width, launches_spatial_bwd_by_width, launches_by_stripe,
              launches_bwd_by_stripe, launches_feats_by_stripe):
        d.clear()


def _count(key, by_width):
    by_width[key] = by_width.get(key, 0) + 1


def ep_apply(y, mode, clamp, a=None, m=None):
    if mode == "none":
        return y
    if mode == "add":
        return a + y
    if mode == "sub_from":
        return a - y
    if mode == "sig_exp":
        return torch.exp(clamp * (2.0 * torch.sigmoid(y) - 1.0))
    if mode == "sig_exp_neg":
        return torch.exp(-clamp * (2.0 * torch.sigmoid(y) - 1.0))
    if mode == "mul_add":
        return a * m + y
    if mode == "sub_mul":
        return (a - y) * m
    raise ValueError(mode)


def padded_gc(gc):
    """Channels a growth segment takes in the kernels' feats buffer, as the
    forward kernel's library reports it (the one place the rule lives)."""
    return _library("dense_chain").selfc_dense_chain_padded_gc(gc)


def _acc_dtype(t):
    """The type sums and the epilogue run in: fp32 (fp64 for fp64 input)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def padded_width(t, gc, P):
    """The concat ``(…,4gc)`` -> the feats layout ``(…,4P)`` with zero pad
    lanes (the inverse of ``true_width``)."""
    if P == gc:
        return t
    return F.pad(t.reshape(*t.shape[:-1], 4, gc), (0, P - gc)).reshape(*t.shape[:-1], 4 * P)


def pick_pack_w(B: int, W: int) -> int:
    """Images laid side by side along W (JAX ``_pick_pack_w``, rule for
    rule): none where W is a multiple of 16 and at least 96; else the first
    of 8, 4, 2 that divides B and makes a packed row of 64..192 columns, a
    multiple of 16; else 1."""
    if W % 16 == 0 and W >= 96:
        return 1
    for P in (8, 4, 2):
        if B % P == 0 and 64 <= P * W <= 192 and (P * W) % 16 == 0:
            return P
    return 1


def pack_w(x, P):
    """``(B,T,H,W,C) -> (B/P,T,H,P*W,C)``: batch entry ``b*P + p`` becomes
    stripe p of packed entry b (JAX ``_pack_w``). A new contiguous tensor."""
    B, T, H, W, C = x.shape
    return (x.reshape(B // P, P, T, H, W, C).permute(0, 2, 3, 1, 4, 5)
            .reshape(B // P, T, H, P * W, C))


def unpack_w(y, P):
    """The inverse of ``pack_w`` (JAX ``_unpack_w``)."""
    Bp, T, H, PW, C = y.shape
    return (y.reshape(Bp, T, H, P, PW // P, C).permute(0, 3, 1, 2, 4, 5)
            .reshape(Bp * P, T, H, PW // P, C))


def _stripes(x, stripe_w):
    """The number of images a row of ``x (B,T,H,W,C)`` holds at stripe width
    ``stripe_w`` (1 where ``stripe_w`` is 0: not packed); raises unless W is
    a multiple of it."""
    W = x.shape[3]
    if stripe_w < 0 or (stripe_w and W % stripe_w):
        raise ValueError(f"stripe_w {stripe_w}: W = {W} must be a multiple of it")
    return W // stripe_w if stripe_w else 1


def true_width(t, gc):
    """A feats-layout tensor ``(…,4P)`` (P >= gc lanes a growth segment, the
    first gc real) -> the concat ``(…,4gc)`` of the real lanes."""
    P = t.shape[-1] // 4
    if P == gc:
        return t
    return t.reshape(*t.shape[:-1], 4, P)[..., :gc].reshape(*t.shape[:-1], 4 * gc)


# ---------------------------------------------------------------------------
# plain PyTorch versions (any growth width)
# ---------------------------------------------------------------------------


def chain_feats_plain(x, ws, bs, stripe_w=0):
    """Plain version of the spatial-only forward: ``[x_1 | .. | x_4]``.
    ``stripe_w``: x is W-packed with images of that width (unpacked, run
    per image, packed again)."""
    if stripe_w:
        P = _stripes(x, stripe_w)
        return pack_w(chain_feats_plain(unpack_w(x, P), ws, bs), P)
    B, T, H, W, C = x.shape
    feats = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    for w, b in zip(ws, bs):
        y = F.conv2d(feats, w.to(x.dtype).permute(3, 2, 0, 1),
                     b.to(x.dtype), padding=1)
        feats = torch.cat([feats, F.leaky_relu(y, 0.2)], dim=1)
    return feats[:, C:].permute(0, 2, 3, 1).reshape(B, T, H, W, -1).contiguous()


def _conv5_ep_plain(x, feats, w5, b5, mode, clamp, a, m):
    """conv5 over ``[x | feats]`` and the epilogue, in fp32, rounded to
    x's dtype."""
    acc = _acc_dtype(x)
    y5 = temporal_conv3(torch.cat([x, feats], dim=-1), w5.to(x.dtype),
                        b5.to(x.dtype)).to(acc)
    n_aux = EP_AUX[mode]
    aa = a.to(acc) if n_aux >= 1 else None
    mm = m.to(acc) if n_aux >= 2 else None
    return ep_apply(y5, mode, clamp, aa, mm).to(x.dtype)


def dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode="none", clamp=1.0,
                           a=None, m=None, stripe_w=0):
    """Plain PyTorch version of the chain, differentiable by autograd. The
    epilogue runs in fp32 and the result returns in x's dtype, as in the
    kernel. ``stripe_w``: x (and a, m) are W-packed with images of that
    width."""
    if stripe_w:
        P = _stripes(x, stripe_w)
        n_aux = EP_AUX[mode]
        a, m = (unpack_w(t, P) if i < n_aux else None for i, t in enumerate((a, m)))
        return pack_w(dense_chain_t_ep_plain(unpack_w(x, P), ws, bs, w5, b5, mode, clamp, a, m), P)
    return _conv5_ep_plain(x, chain_feats_plain(x, ws, bs), w5, b5, mode,
                           clamp, a, m)


def chain_spatial_bwd_plain(x, ws, bs, feats, g, dx0=None, stripe_w=0):
    """Plain version of the chain adjoint, written as the explicit sweep and
    not as autograd of the forward. ``feats`` and ``g`` (the gradient that
    reaches feats directly) are ``(B,T,H,W,4P)`` in either feats layout
    (pad lanes of g are ignored), ``dx0`` (optional) the gradient that
    reaches ``x`` directly. Returns ``(dx, dws, dbs)`` in the types of
    ``x``, ``ws``, ``bs``. The running gradient is fp32 whatever the inputs
    are, and so are the products (bf16 inputs are widened first).
    ``stripe_w``: every tensor is W-packed with images of that width."""
    if stripe_w:
        P = _stripes(x, stripe_w)
        un = lambda t: None if t is None else unpack_w(t, P)  # noqa: E731
        dx, dws, dbs = chain_spatial_bwd_plain(un(x), ws, bs, un(feats), un(g), un(dx0))
        return pack_w(dx, P), dws, dbs
    B, T, H, W, C = x.shape
    N, acc = B * T, _acc_dtype(x)
    gc = ws[0].shape[-1]
    feats, g = true_width(feats, gc), true_width(g, gc)
    nchw = lambda t: t.reshape(N, H, W, -1).permute(0, 3, 1, 2).to(acc)  # noqa: E731
    work = torch.cat([nchw(x), nchw(feats)], dim=1)
    dx = torch.zeros_like(work[:, :C]) if dx0 is None else nchw(dx0)
    dwork = torch.cat([dx, nchw(g)], dim=1)
    dws, dbs = [None] * 4, [None] * 4
    for k in (3, 2, 1, 0):
        kin = C + gc * k
        out, dout = work[:, kin:kin + gc], dwork[:, kin:kin + gc]
        # the slope is chosen by the sign of the saved output; 0 -> 0.2
        dacc = torch.where(out > 0, dout, 0.2 * dout)
        dbs[k] = dacc.sum(dim=(0, 2, 3)).to(bs[k].dtype)
        # dW[dy,dx] = shifted(input)^T @ dacc, zero outside the image
        src = F.pad(work[:, :kin], (1, 1, 1, 1)).permute(0, 2, 3, 1)
        d2 = dacc.permute(0, 2, 3, 1).reshape(-1, gc)
        dw = torch.stack([
            torch.stack([src[:, dy:dy + H, dx_:dx_ + W].reshape(-1, kin).t() @ d2
                         for dx_ in range(3)]) for dy in range(3)])
        dws[k] = dw.to(ws[k].dtype)
        # the conv's adjoint: conv_transpose2d takes (Cout, Cin, kh, kw)
        dwork[:, :kin] += F.conv_transpose2d(
            dacc, ws[k].to(acc).permute(3, 2, 0, 1), padding=1)
    dx = dwork[:, :C].permute(0, 2, 3, 1).reshape(x.shape).to(x.dtype)
    return dx, dws, dbs


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _library(name):
    """A kernel library, its C signatures set at the first call."""
    lib = build.load(name)
    if name == "dense_chain" and lib.selfc_dense_chain_forward.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.selfc_dense_chain_forward.argtypes = [P] * 15 + [I] * 8 + [ctypes.c_float, I, I, P]
        lib.selfc_dense_chain_forward.restype = I
        lib.selfc_dense_chain_feats.argtypes = [P] * 10 + [I] * 7 + [P]
        lib.selfc_dense_chain_feats.restype = I
        lib.selfc_dense_chain_padded_gc.argtypes = [I]
        lib.selfc_dense_chain_padded_gc.restype = I
        lib.selfc_cuda_error_string.argtypes = [I]
        lib.selfc_cuda_error_string.restype = ctypes.c_char_p
    if name == "dense_chain_bwd" and lib.selfc_dense_chain_spatial_backward.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.selfc_dense_chain_spatial_backward.argtypes = [P] * 17 + [I] * 9 + [P]
        lib.selfc_dense_chain_spatial_backward.restype = I
        lib.selfc_dense_chain_bwd_padded_gc.argtypes = [I]
        lib.selfc_dense_chain_bwd_padded_gc.restype = I
        lib.selfc_bwd_cuda_error_string.argtypes = [I]
        lib.selfc_bwd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _stream(x):
    """PyTorch's current stream on x's device, as an integer handle."""
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err, what, error_string):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {error_string(err).decode()} ({err})")


def _check(name, t, shape, like, dtype=None):
    dtype = like.dtype if dtype is None else dtype
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != like.device or t.dtype != dtype:
        raise ValueError(
            f"{name}: {t.dtype} on {t.device}, expected {dtype} on "
            f"{like.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be aligned to 16 bytes (the kernels use vector loads)")


def _validate_spatial(x, ws, bs, stripe_w=0):
    """Raise on anything the spatial kernels do not take. Every tensor must
    be of x's dtype, on x's device, contiguous and aligned to 16 bytes; the
    growth width gc (the weights' last axis) in 1..32; W a multiple of
    ``stripe_w`` (0: not packed)."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dense chain kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x: expected (B,T,H,W,C), got shape {tuple(x.shape)}")
    if len(ws) != 4 or len(bs) != 4:
        raise ValueError("the chain has four spatial convs")
    B, T, H, W, C = x.shape
    gc = ws[0].shape[-1]
    if not 1 <= gc <= GC_MAX:
        raise ValueError(f"growth width {gc}: the kernels take 1..{GC_MAX}")
    _stripes(x, stripe_w)
    _check("x", x, x.shape, x)
    for k in range(4):
        _check(f"w{k + 1}", ws[k], (3, 3, C + gc * k, gc), x)
        _check(f"b{k + 1}", bs[k], (gc,), x)
    if B * T > 65535:
        raise ValueError(f"B*T = {B * T} exceeds the kernel's grid limit 65535")


def _validate(x, ws, bs, w5, b5, mode, a, m, stripe_w=0):
    """Raise on anything the forward kernels do not take. Tensors that
    require grad are fine: the gradient has kernels of its own."""
    _validate_spatial(x, ws, bs, stripe_w)
    B, T, H, W, C = x.shape
    c_out = w5.shape[-1]
    _check("w5", w5, (3, C + 4 * ws[0].shape[-1], c_out), x)
    _check("b5", b5, (c_out,), x)
    for name, t in zip("am", (a, m)[:EP_AUX[mode]]):
        _check(name, t, (B, T, H, W, c_out), x)


def _chain_cuda(x, ws, bs, w5, b5, mode, clamp, a, m, stripe_w=0):
    """The forward kernels: ``(out, feats)``, feats being the buffer the
    spatial layers wrote (a new one each call, so the caller may keep it),
    ``(B,T,H,W,4*padded_gc(gc))`` with zeros in each segment's pad lanes.
    ``stripe_w``: x (and a, m) are W-packed with images of that width."""
    global launches
    _validate(x, ws, bs, w5, b5, mode, a, m, stripe_w)
    B, T, H, W, C = x.shape
    c_out, gc = w5.shape[-1], ws[0].shape[-1]
    feats = torch.empty((B, T, H, W, 4 * padded_gc(gc)), dtype=x.dtype, device=x.device)
    out = torch.empty((B, T, H, W, c_out), dtype=x.dtype, device=x.device)
    _launch_forward(x, ws, bs, w5, b5, mode, clamp, a, m, feats, out, stripe_w)
    launches += 1
    _count((C, c_out, gc), launches_by_width)
    _count((C, c_out, gc, int(stripe_w)), launches_by_stripe)
    return out, feats


def _launch_forward(x, ws, bs, w5, b5, mode, clamp, a, m, feats, out, stripe_w=0):
    """The forward kernels into the buffers ``feats`` and ``out`` (whatever
    they held: every lane is written), uncounted; the caller validated."""
    B, T, H, W, C = x.shape
    c_out, gc = w5.shape[-1], ws[0].shape[-1]
    n_aux = EP_AUX[mode]
    lib = _library("dense_chain")
    err = lib.selfc_dense_chain_forward(
        x.data_ptr(), feats.data_ptr(),
        *(w.data_ptr() for w in ws), *(b.data_ptr() for b in bs),
        w5.data_ptr(), b5.data_ptr(),
        a.data_ptr() if n_aux >= 1 else None,
        m.data_ptr() if n_aux >= 2 else None,
        out.data_ptr(), B * T, T, H, W, C, gc, c_out, _EP_CODE[mode],
        float(clamp), int(stripe_w), _DTYPE_CODE[x.dtype], _stream(x),
    )
    _raise_on(err, "dense chain", lib.selfc_cuda_error_string)


def _feats_cuda(x, ws, bs, stripe_w=0):
    """The spatial-only forward kernels: a new feats buffer
    ``(B,T,H,W,4*padded_gc(gc))`` with zero pad lanes. ``stripe_w``: x is
    W-packed with images of that width."""
    global launches_feats
    _validate_spatial(x, ws, bs, stripe_w)
    B, T, H, W, C = x.shape
    gc = ws[0].shape[-1]
    feats = torch.empty((B, T, H, W, 4 * padded_gc(gc)), dtype=x.dtype, device=x.device)
    _launch_feats(x, ws, bs, feats, stripe_w)
    launches_feats += 1
    _count((C, gc), launches_feats_by_width)
    _count((C, gc, int(stripe_w)), launches_feats_by_stripe)
    return feats


def _launch_feats(x, ws, bs, feats, stripe_w=0):
    """The spatial-only forward kernels into the buffer ``feats`` (whatever
    it held), uncounted; the caller validated."""
    B, T, H, W, C = x.shape
    lib = _library("dense_chain")
    err = lib.selfc_dense_chain_feats(
        x.data_ptr(), feats.data_ptr(),
        *(w.data_ptr() for w in ws), *(b.data_ptr() for b in bs),
        B * T, H, W, C, ws[0].shape[-1], int(stripe_w), _DTYPE_CODE[x.dtype], _stream(x),
    )
    _raise_on(err, "dense chain feats", lib.selfc_cuda_error_string)


def _bwd_cuda(x, ws, bs, feats, dfeats, dx, stripe_w=0):
    """The adjoint kernels. ``feats`` is the forward kernels' buffer,
    ``dfeats`` an fp32 one of its shape, ``(B,T,H,W,4*padded_gc(gc))``, and
    ``dx (B,T,H,W,C)`` fp32; dfeats and dx hold, on entry, the gradients
    that reach feats and x directly (the pad lanes of dfeats are never
    read); both are updated in place: dx ends as the whole gradient
    (``dx=None``: not wanted), each slot of dfeats as its layer's gradient
    behind the LeakyReLU, pad lanes 0. Returns ``(dws, dbs)``
    in the weights' dtype, at the true gc. ``stripe_w``: every tensor is
    W-packed with images of that width."""
    global launches_bwd
    _validate_spatial(x, ws, bs, stripe_w)
    B, T, H, W, C = x.shape
    gc = ws[0].shape[-1]
    P = feats.shape[-1] // 4 if feats.dim() == 5 else 0
    if not gc <= P <= GC_MAX:
        raise ValueError(f"feats: shape {tuple(feats.shape)}, expected four growth "
                         f"segments of {gc}..{GC_MAX} lanes")
    _check("feats", feats, (B, T, H, W, 4 * P), x)
    _check("dfeats", dfeats, (B, T, H, W, 4 * P), x, torch.float32)
    if dx is not None:
        _check("dx", dx, x.shape, x, torch.float32)
    lib = _library("dense_chain_bwd")
    gcp = padded_gc(gc)
    if lib.selfc_dense_chain_bwd_padded_gc(gc) != gcp:
        raise RuntimeError(f"growth width {gc}: the forward and adjoint libraries "
                           "disagree on the feats layout")
    if P != gcp:
        raise ValueError(f"feats: {P} lanes a growth segment; the kernels' layout "
                         f"has {gcp} at growth width {gc}")
    dws = [torch.empty_like(w) for w in ws]
    dbs = [torch.empty_like(b) for b in bs]
    groups = max(1, min(BWD_GROUPS, B * T * H * W // 128))
    partial = torch.empty(groups * (9 * (C + 3 * gc) * gc + gc), dtype=torch.float32,
                          device=x.device)
    err = lib.selfc_dense_chain_spatial_backward(
        x.data_ptr(), feats.data_ptr(), *(w.data_ptr() for w in ws),
        dfeats.data_ptr(), dx.data_ptr() if dx is not None else None,
        *(t.data_ptr() for t in dws), *(t.data_ptr() for t in dbs),
        partial.data_ptr(), groups, B * T, H, W, C, gc, int(dx is not None),
        int(stripe_w), _DTYPE_CODE[x.dtype], _stream(x),
    )
    _raise_on(err, "dense chain backward", lib.selfc_bwd_cuda_error_string)
    launches_bwd += 1
    _count((C, gc), launches_bwd_by_width)
    _count((C, gc, int(stripe_w)), launches_bwd_by_stripe)
    return dws, dbs


# ---------------------------------------------------------------------------
# wrappers: a CUDA tensor goes to the kernels or raises, a CPU tensor to the
# plain version
# ---------------------------------------------------------------------------


def chain_feats(x, ws, bs, stripe_w=0):
    """The spatial-only forward ``[x_1 | .. | x_4]`` in its device's feats
    layout (not differentiable: it serves the backward of
    ``dense_chain_t_ep``; ``fused_dense_spatial`` is the differentiable
    spatial chain). ``stripe_w``: x is W-packed with images of that width."""
    if not x.is_cuda:
        return chain_feats_plain(x, ws, bs, stripe_w)
    return _feats_cuda(x, ws, bs, stripe_w)


def chain_spatial_bwd(x, ws, bs, feats, g, dx0=None, stripe_w=0):
    """The adjoint of the four spatial convs; arguments and result as
    ``chain_spatial_bwd_plain``. On a CUDA tensor ``feats`` and ``g`` are in
    the kernels' layout, as ``chain_feats`` gives it there."""
    if not x.is_cuda:
        return chain_spatial_bwd_plain(x, ws, bs, feats, g, dx0, stripe_w)
    gc = ws[0].shape[-1]
    dfeats = g.to(torch.float32, copy=True)  # the kernels update both in place
    P = dfeats.shape[-1] // 4
    dfeats.view(*dfeats.shape[:-1], 4, P)[..., gc:] = 0
    dx = (torch.zeros(x.shape, dtype=torch.float32, device=x.device) if dx0 is None
          else dx0.to(torch.float32, copy=True))
    dws, dbs = _bwd_cuda(x, ws, bs, feats, dfeats, dx, stripe_w)
    return dx.to(x.dtype), dws, dbs


def _conv5_adjoint(x, feats, w5, dy5, need_dx):
    """Adjoint of conv5 (a (3,1,1) conv, zero padded in T) over the two
    sources x and feats, as plain products in fp32: ``(dw5, db5, dfeats,
    dx)``. The three taps are folded into one contraction: with
    ``S = [dy5(t+1) | dy5(t) | dy5(t-1)]`` (zero outside the clip),
    ``d[x|feats] = S @ [w5[0] | w5[1] | w5[2]]^T`` and
    ``dw5 = [x|feats]^T @ S``. ``feats`` may be in either layout: w5's
    feature rows are scattered to its real lanes (zero rows at the pad
    lanes, so dfeats has zero pad lanes) and dw5's gathered back from them."""
    B, T, H, W, C = x.shape
    c_out, acc = w5.shape[-1], dy5.dtype
    gc = (w5.shape[1] - C) // 4
    P = feats.shape[-1] // 4
    dyp = F.pad(dy5, (0, 0, 0, 0, 0, 0, 1, 1))
    S = torch.cat([dyp[:, 2 - dt:2 - dt + T] for dt in range(3)], dim=-1)
    S2 = S.reshape(-1, 3 * c_out)
    wt = w5.to(acc).permute(0, 2, 1).reshape(3 * c_out, C + 4 * gc)
    dfeats = (S2 @ padded_width(wt[:, C:], gc, P)).reshape(feats.shape)
    dx = (S2 @ wt[:, :C]).reshape(x.shape) if need_dx else None
    dwf = true_width((feats.reshape(-1, 4 * P).to(acc).t() @ S2).t(), gc).t()
    dw5 = torch.cat([x.reshape(-1, C).to(acc).t() @ S2, dwf])
    dw5 = dw5.reshape(-1, 3, c_out).permute(1, 0, 2)
    return dw5, dy5.sum(dim=(0, 1, 2, 3)), dfeats, dx


class _DenseChainEp(torch.autograd.Function):
    """``dense_chain_t_ep`` on tensors already cast to x's dtype. The
    backward: (1) feats, saved by the forward or recomputed by the
    spatial-only forward; (2) the epilogue's adjoint, elementwise in fp32
    (``sub_mul`` recomputes conv5's output for dm, through the temporal-conv
    kernel on a CUDA tensor);
    (3) conv5's adjoint as plain products (it is outside the kernels on the
    JAX side too), written into the fp32 ``dx`` / ``dfeats`` pair; (4) the
    chain adjoint, in place on that pair; (5) dx rounded to x's dtype.
    ``stripe``: every tensor is W-packed with images of that width (JAX
    ``_fused_chain_ep(..., stripe)``); the spatial steps take the stripe
    masks, conv5 and the epilogue (temporal, pointwise) run unchanged."""

    @staticmethod
    def forward(ctx, mode, clamp, save_feats, launch, stripe, x, w5, b5, a, m, *wbs):
        ws, bs = list(wbs[:4]), list(wbs[4:])
        if x.is_cuda and launch is not None:  # another schedule: it keeps no features
            out, feats = launch(x, ws, bs, w5, b5, mode, clamp, a, m), None
        elif x.is_cuda:
            out, feats = _chain_cuda(x, ws, bs, w5, b5, mode, clamp, a, m, stripe)
        else:
            feats = chain_feats_plain(x, ws, bs, stripe)
            out = _conv5_ep_plain(x, feats, w5, b5, mode, clamp, a, m)
        ctx.mode, ctx.clamp, ctx.stripe = mode, clamp, stripe
        n_aux = EP_AUX[mode]
        # the epilogue's derivative needs: out for the two exp modes, a and
        # m for the products
        keep_out = out if mode in ("sig_exp", "sig_exp_neg") else None
        keep_a = a if n_aux >= 2 else None
        keep_m = m if n_aux >= 2 else None
        ctx.save_for_backward(x, w5, b5, keep_out, keep_a, keep_m,
                              feats if save_feats and launch is None else None, *wbs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w5, b5, out, a, m, feats, *wbs = ctx.saved_tensors
        ws, bs = list(wbs[:4]), list(wbs[4:])
        mode, clamp, stripe = ctx.mode, ctx.clamp, ctx.stripe
        need = ctx.needs_input_grad  # (mode, clamp, save_feats, launch, stripe, x, w5, b5, a, m, *wbs)
        need_x, need_a, need_m = need[5], need[8], need[9]
        acc = _acc_dtype(x)
        if feats is None:
            feats = chain_feats(x, ws, bs, stripe)
        C = x.shape[-1]

        # (2) the epilogue
        g = g.to(acc)
        da = dm = None
        if mode == "none":
            dy5 = g
        elif mode == "add":
            dy5, da = g, g
        elif mode == "sub_from":
            dy5, da = -g, g
        elif mode in ("sig_exp", "sig_exp_neg"):
            # out = exp(+-c t), t = 2 sigmoid(y5) - 1 = +-log(out)/c and
            # dt/dy5 = (1 - t^2)/2
            o = out.to(acc)
            sign = 1.0 if mode == "sig_exp" else -1.0
            dy5 = g * o * (sign * clamp * 0.5) * (1.0 - (torch.log(o) / clamp) ** 2)
        elif mode == "mul_add":
            dy5 = g
            da = g * m.to(acc) if need_a else None
            dm = g * a.to(acc) if need_m else None
        else:  # sub_mul: out = (a - y5) * m
            gm = g * m.to(acc)
            dy5, da = -gm, gm
            if need_m:
                # conv5 again: the temporal-conv kernel on a CUDA tensor
                y5 = tc.temporal_conv3_fused(
                    torch.cat([x, true_width(feats, ws[0].shape[-1])], dim=-1), w5, b5).to(acc)
                dm = g * (a.to(acc) - y5)
        dy5 = dy5.contiguous()

        # (3) conv5
        dw5, db5, dfeats, dx = _conv5_adjoint(x, feats, w5, dy5, need_x)

        # (4) the four spatial convs
        if x.is_cuda:
            dws, dbs = _bwd_cuda(x, ws, bs, feats, dfeats, dx, stripe)
        else:
            dx, dws, dbs = chain_spatial_bwd_plain(x, ws, bs, feats, dfeats, dx, stripe)
        return (None, None, None, None, None,
                dx.to(x.dtype) if need_x else None,
                dw5.to(w5.dtype), db5.to(b5.dtype),
                da.to(x.dtype) if da is not None and need_a else None,
                dm.to(x.dtype) if dm is not None and need_m else None,
                *dws, *dbs)


def dense_chain_t_ep(x, ws, bs, w5, b5, mode="none", clamp=1.0, a=None,
                     m=None, save_feats=True, launch=None, stripe=0, pack=False):
    """The chain with its epilogue, differentiable. A CUDA tensor goes to
    the kernels (or raises on what they do not take); a CPU tensor to the
    plain versions. Parameters are cast to x's dtype first, outside the
    autograd function, so that under bf16 activations the gradients reach
    fp32 master parameters through the cast.

    ``save_feats``: keep the forward's ``(B,T,H,W,4*GCP)`` feats buffer for
    the backward (the default); false frees it and makes the backward
    recompute it with the spatial-only forward.

    ``launch``: the forward kernels of another schedule of the same function
    on a CUDA tensor (``ops/chain_variants.py``: B8, B9), called as
    ``_chain_cuda`` is and returning the output alone; the backward then
    recomputes the features. None: B1.

    ``stripe``: x (and a, m) arrive W-packed with images of that width (the
    coupling chain packs once, ``models/inv_nets.py``); B1, B3 and B2 take
    the stripe masks. Only B1 has them: ``launch`` must be None.

    ``pack``: without a ``stripe``, pack the call itself where
    ``pick_pack_w(B, W)`` gives P > 1 (x, a and m packed, the output
    unpacked; autograd unpacks the gradients), as JAX ``_impl_best`` and
    ``_fused_chain_ep`` do."""
    if mode not in EP_AUX:
        raise ValueError(mode)
    if stripe and launch is not None:
        raise ValueError("under a stripe only B1 runs: the other schedules have no stripe masks")
    n_aux = EP_AUX[mode]
    P = pick_pack_w(x.shape[0], x.shape[3]) if pack and not stripe and x.dim() == 5 else 1
    if P > 1:
        stripe = x.shape[3]
        x, a, m = (pack_w(t, P) if i <= n_aux else None for i, t in enumerate((x, a, m)))
    dt = x.dtype
    y = _DenseChainEp.apply(
        mode, float(clamp), bool(save_feats), launch, int(stripe), x, w5.to(dt), b5.to(dt),
        a if n_aux >= 1 else None, m if n_aux >= 2 else None,
        *(w.to(dt) for w in ws), *(b.to(dt) for b in bs),
    )
    return unpack_w(y, P) if P > 1 else y


# ---------------------------------------------------------------------------
# the v1 spatial chain (conv5 outside): selfc_tpu/ops/pallas_chain.py
# fused_dense_spatial, a route over the spatial-only forward and the adjoint
# ---------------------------------------------------------------------------


def fused_dense_spatial_plain(x, ws, bs):
    """Plain version of ``fused_dense_spatial``, differentiable by autograd."""
    x5 = x if x.dim() == 5 else x[:, None]
    out = chain_feats_plain(x5, [w.to(x.dtype) for w in ws], [b.to(x.dtype) for b in bs])
    return out if x.dim() == 5 else out[:, 0]


class _FusedDenseSpatial(torch.autograd.Function):
    """``fused_dense_spatial`` on 5-d tensors already cast to x's dtype.
    Forward: the spatial-only forward, whose feats buffer is the result (at
    gc 32 it has no pad lanes) and is kept for the backward. Backward: the
    chain adjoint from those features, as JAX's ``_fds_bwd`` takes
    ``_pallas_bwd``."""

    @staticmethod
    def forward(ctx, x, *wbs):
        global launches_spatial
        ws, bs = list(wbs[:4]), list(wbs[4:])
        if x.is_cuda:
            out = _feats_cuda(x, ws, bs)
            launches_spatial += 1
            _count((x.shape[-1], GC_MAX), launches_spatial_by_width)
        else:
            out = chain_feats_plain(x, ws, bs)
        ctx.save_for_backward(x, out, *wbs)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        global launches_spatial_bwd
        x, feats, *wbs = ctx.saved_tensors
        ws, bs = list(wbs[:4]), list(wbs[4:])
        if x.is_cuda:
            dfeats = g.to(torch.float32, copy=True).contiguous()
            dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            dws, dbs = _bwd_cuda(x, ws, bs, feats, dfeats, dx)
            launches_spatial_bwd += 1
            _count((x.shape[-1], GC_MAX), launches_spatial_bwd_by_width)
        else:
            dx, dws, dbs = chain_spatial_bwd_plain(x, ws, bs, feats, g)
        return (dx.to(x.dtype) if ctx.needs_input_grad[0] else None), *dws, *dbs


def fused_dense_spatial(x, ws, bs):
    """The four spatial convs of the dense chain alone, differentiable:
    ``x (B,T,H,W,C)`` or ``(N,H,W,C)`` -> the concat ``[x_1 | .. | x_4]``
    ``(…,128)``, growth width 32 (the v1 kernel's). A CUDA tensor goes to
    the kernels (or raises on what they do not take), a CPU tensor to the
    plain versions. Parameters are cast to x's dtype outside the autograd
    function, as in ``dense_chain_t_ep``."""
    gc = ws[0].shape[-1]
    if gc != GC_MAX:
        raise ValueError(f"growth width {gc}: the v1 spatial chain takes {GC_MAX} only")
    if x.dim() not in (4, 5):
        raise ValueError(f"x: expected (B,T,H,W,C) or (N,H,W,C), got shape {tuple(x.shape)}")
    x5 = x if x.dim() == 5 else x[:, None]
    dt = x.dtype
    out = _FusedDenseSpatial.apply(x5.contiguous(), *(w.to(dt) for w in ws), *(b.to(dt) for b in bs))
    return out if x.dim() == 5 else out[:, 0]
