"""The modulated deformable 3x3 convolution (``deform_conv2d``) and its
gradient.

Replaces ``selfc_tpu/ops/deform.py:_deform_tile_kernel`` (reached there
through ``_deform_pallas_impl`` and ``deform_conv2d_pallas``). The function,
on channels-last tensors ``x (N,H,W,C)``, ``offset (N,H,W,18)``, ``mask
(N,H,W,9)`` and ``weight (3,3,C,Cout)``, stride 1, padding 1:

  out(p) = sum_{k = 3i+j} mask_k(p) * bil(x, h+i-1+dy_k(p), w+j-1+dx_k(p)) @ weight[i,j]

with ``(dy_k, dx_k)`` at offset channels ``(2k, 2k+1)`` (torchvision's
order) and ``bil`` the bilinear sample whose four corners are each zero
where they fall outside the frame. The bias, where there is one, is added
outside the kernel, as the JAX package's Pallas path adds it.

On a CUDA tensor ``deform_conv2d`` runs the hand-written kernels of
``csrc/deform.cu`` (forward; backward as one pass over pixel tiles that
forms dmask, doffset, dx in 64-bit fixed point and per-block sums of dW, a
fixed-order reduction of those sums, and the conversion of dx) or raises.
Both directions give the same bits on every run. There is no
shape gate that falls back to the composition, unlike the JAX package's
``deform_pallas_ok``: the kernels take any N, H, W, C and Cout. On a CPU
tensor it runs the plain versions below, the composition forward and the
closed-form adjoint. ``deform_conv2d_windowed`` (bounded displacement) is
plain tensor code on both devices, as on the JAX side.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..kernels import build
from . import dense_chain as dc

K = 3
KK = K * K

# calls that went to the CUDA kernels, in all and by (C, Cout): the forward,
# and the backward (one call makes its four launches)
launches = 0
launches_by_width: dict = {}
launches_bwd = 0
launches_bwd_by_width: dict = {}


def reset_launch_counts():
    global launches, launches_bwd
    launches = launches_bwd = 0
    launches_by_width.clear()
    launches_bwd_by_width.clear()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _tap(x, offset, k):
    """The four bilinear corners of tap ``k``'s sample points in ``x
    (N,H,W,C)``: a list of ``(index, valid, sy, sx)``, ``index`` the flat
    pixel index ``(N*H*W,)`` of the corner clamped into the frame and
    ``valid`` whether it lies inside; and the fractional parts ``(wy, wx)``.
    A point is ``(h + i - 1) + dy``, formed as the kernel forms it (the
    integer part exact, one rounding); ``floor`` carries no gradient."""
    N, H, W, _ = x.shape
    i, j = divmod(k, K)
    gy = torch.arange(H, dtype=offset.dtype, device=offset.device).view(1, H, 1)
    gx = torch.arange(W, dtype=offset.dtype, device=offset.device).view(1, 1, W)
    py = (gy + (i - 1)) + offset[..., 2 * k]
    px = (gx + (j - 1)) + offset[..., 2 * k + 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    base = (torch.arange(N, device=x.device) * (H * W)).view(N, 1, 1)
    out = []
    for sy, sx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = y0 + sy, x0 + sx
        valid = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        idx = base + yy.clamp(0, H - 1).long() * W + xx.clamp(0, W - 1).long()
        out.append((idx.reshape(-1), valid, sy, sx))
    return out, py - y0, px - x0


def _gather(xf, idx, valid, shape):
    return xf.index_select(0, idx).reshape(shape) * valid[..., None]


def _corner_weight(wy, wx, sy, sx):
    return (wy if sy else 1 - wy) * (wx if sx else 1 - wx)


def deform_conv2d_plain(x, offset, mask, weight, bias=None):
    """The gather composition (``selfc_tpu/ops/deform.py:deform_conv2d``),
    differentiable by autograd: the oracle. Sums run in fp32 (fp64 for fp64
    input) and the result returns in x's dtype, as in the kernel."""
    acc = dc._acc_dtype(x)
    xs, off, m, w = (t.to(acc) for t in (x, offset, mask, weight))
    xf = xs.reshape(-1, xs.shape[-1])
    out = 0.0
    for k in range(KK):
        corners, wy, wx = _tap(xs, off, k)
        val = sum(_gather(xf, idx, valid, xs.shape) * _corner_weight(wy, wx, sy, sx)[..., None]
                  for idx, valid, sy, sx in corners)
        out = out + torch.matmul(val * m[..., k, None], w[k // K, k % K])
    if bias is not None:
        out = out + bias.to(acc)
    return out.to(x.dtype)


def deform_conv2d_bwd_plain(x, offset, mask, weight, g):
    """The closed-form adjoint of ``deform_conv2d`` (without bias) for the
    output gradient ``g (N,H,W,Cout)``: ``(dx, doffset, dmask, dweight)`` in
    the types of the inputs, what the CUDA backward computes. With ``bil_k``
    the bilinear sample of tap k and ``dval_k = g @ W_k^T``:

      dW_k     = sum_p (mask_k * bil_k)^T g
      dmask_k  = <dval_k, bil_k>
      doffset  = mask_k * <dval_k, d bil_k / d(wy, wx)>   (floor has no gradient;
                                                          a corner outside adds nothing)
      dx       = scatter of mask_k * w_corner * dval_k to the four corners
    """
    acc = dc._acc_dtype(x)
    C = x.shape[-1]
    xs, off, m, w, g = (t.to(acc) for t in (x, offset, mask, weight, g))
    xf = xs.reshape(-1, C)
    g2 = g.reshape(-1, g.shape[-1])
    dx = torch.zeros_like(xf)
    doff = torch.empty_like(off)
    dmask = torch.empty_like(m)
    dw = torch.empty_like(w)
    for k in range(KK):
        i, j = divmod(k, K)
        corners, wy, wx = _tap(xs, off, k)
        v = [_gather(xf, idx, valid, xs.shape) for idx, valid, _, _ in corners]
        v00, v01, v10, v11 = v
        bil = sum(vc * _corner_weight(wy, wx, sy, sx)[..., None]
                  for vc, (_, _, sy, sx) in zip(v, corners))
        mk = m[..., k]
        dval = torch.matmul(g, w[i, j].t())
        dw[i, j] = (bil * mk[..., None]).reshape(-1, C).t() @ g2
        dmask[..., k] = (dval * bil).sum(-1)
        d_wy = (1 - wx)[..., None] * (v10 - v00) + wx[..., None] * (v11 - v01)
        d_wx = (1 - wy)[..., None] * (v01 - v00) + wy[..., None] * (v11 - v10)
        doff[..., 2 * k] = mk * (dval * d_wy).sum(-1)
        doff[..., 2 * k + 1] = mk * (dval * d_wx).sum(-1)
        for idx, valid, sy, sx in corners:
            cw = mk * _corner_weight(wy, wx, sy, sx) * valid
            dx.index_add_(0, idx, (cw[..., None] * dval).reshape(-1, C))
    return (dx.reshape(x.shape).to(x.dtype), doff.to(offset.dtype), dmask.to(mask.dtype),
            dw.to(weight.dtype))


def _hat(t):
    """The bilinear interpolation kernel max(0, 1 - |t|)."""
    return torch.clamp(1.0 - t.abs(), min=0.0)


def deform_conv2d_windowed(x, offset, mask, weight, bias=None, radius=3):
    """The gather-free formulation with each tap's total displacement
    clamped to ``[-radius, radius]`` (``selfc_tpu/ops/deform.py:
    deform_conv2d_windowed``): the bilinear sample as a sum over the
    (2R+1)^2 integer shifts of one zero-padded copy of x with hat weights,
    then one contraction of the 9 tap maps against the weight. Equal to
    ``deform_conv2d`` while every displacement stays inside the window.
    Plain tensor code on every device (no kernel on either side)."""
    N, H, W, C = x.shape
    R = int(radius)
    xp = F.pad(x, (0, 0, R, R, R, R))
    dys, dxs = [], []
    for i in range(K):
        for j in range(K):
            k = i * K + j
            dys.append(torch.clamp(offset[..., 2 * k] + (i - K // 2), -R, R))
            dxs.append(torch.clamp(offset[..., 2 * k + 1] + (j - K // 2), -R, R))
    dy, dx = torch.stack(dys, -1), torch.stack(dxs, -1)
    acc = [torch.zeros_like(x) for _ in range(KK)]
    for sy in range(-R, R + 1):
        wy = _hat(dy - sy)
        for sx in range(-R, R + 1):
            w = (wy * _hat(dx - sx) * mask).to(x.dtype)
            xs = xp[:, R + sy:R + sy + H, R + sx:R + sx + W, :]
            for k in range(KK):
                acc[k] = acc[k] + w[..., k:k + 1] * xs
    stacked = torch.stack(acc, dim=-2)  # (N,H,W,9,C)
    acc_dt = dc._acc_dtype(x)
    out = torch.einsum("nhwkc,kcd->nhwd", stacked.to(acc_dt), weight.reshape(KK, C, -1).to(acc_dt)).to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------


def _library():
    """The kernel library, its C signatures set at the first call."""
    lib = build.load("deform")
    if lib.selfc_deform_forward.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.selfc_deform_forward.argtypes = [P] * 5 + [I] * 6 + [P]
        lib.selfc_deform_forward.restype = I
        lib.selfc_deform_backward.argtypes = [P] * 12 + [I] * 6 + [P]
        lib.selfc_deform_backward.restype = I
        lib.selfc_deform_backward_tiles.argtypes = [I] * 3
        lib.selfc_deform_backward_tiles.restype = I
        lib.selfc_deform_cuda_error_string.argtypes = [I]
        lib.selfc_deform_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, like, dtype=None):
    dtype = like.dtype if dtype is None else dtype
    if t.device != like.device or t.dtype != dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {dtype} on {like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _validate(x, offset, mask, weight):
    """Raise on anything the kernels do not take: every tensor of x's dtype
    (float32 or bfloat16), on x's device, contiguous, of the shapes above."""
    if x.dtype not in dc._DTYPE_CODE:
        raise TypeError(f"deformable conv kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x: expected (N,H,W,C), got shape {tuple(x.shape)}")
    N, H, W, C = x.shape
    if weight.dim() != 4:
        raise ValueError(f"weight: expected (3,3,C,Cout), got shape {tuple(weight.shape)}")
    _check("x", x, x.shape, x)
    _check("offset", offset, (N, H, W, 2 * KK), x)
    _check("mask", mask, (N, H, W, KK), x)
    _check("weight", weight, (K, K, C, weight.shape[-1]), x)
    if N * H * W >= 2 ** 31:
        raise ValueError(f"{N * H * W} pixels: the kernels index pixels with 32-bit integers")


def _forward_cuda(x, offset, mask, weight):
    global launches
    _validate(x, offset, mask, weight)
    N, H, W, C = x.shape
    c_out = weight.shape[-1]
    lib = _library()
    out = torch.empty((N, H, W, c_out), dtype=x.dtype, device=x.device)
    err = lib.selfc_deform_forward(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(), out.data_ptr(),
        N, H, W, C, c_out, dc._DTYPE_CODE[x.dtype], dc._stream(x))
    dc._raise_on(err, "deformable conv", lib.selfc_deform_cuda_error_string)
    launches += 1
    dc._count((C, c_out), launches_by_width)
    return out


def _backward_cuda(x, offset, mask, weight, g):
    """``(dx, doffset, dmask, dweight)`` in the inputs' dtype, the same bits
    on every run: dx summed in 64-bit fixed point (integer atomics, whose
    order does not matter), dweight by per-tile partial sums added in a
    fixed order."""
    global launches_bwd
    _validate(x, offset, mask, weight)
    N, H, W, C = x.shape
    c_out = weight.shape[-1]
    _check("g", g, (N, H, W, c_out), x)
    lib = _library()
    dx, doffset, dmask, dweight = (torch.empty_like(t) for t in (x, offset, mask, weight))
    partial = torch.empty(lib.selfc_deform_backward_tiles(N, H, W) * KK * C * c_out, dtype=torch.float32,
                          device=x.device)
    dx_fixed = torch.empty(N * H * W * C, dtype=torch.int64, device=x.device)
    bound = torch.empty(4, dtype=torch.int32, device=x.device)
    err = lib.selfc_deform_backward(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(), g.data_ptr(),
        dx.data_ptr(), doffset.data_ptr(), dmask.data_ptr(), dweight.data_ptr(),
        dx_fixed.data_ptr(), partial.data_ptr(), bound.data_ptr(), N, H, W, C, c_out,
        dc._DTYPE_CODE[x.dtype], dc._stream(x))
    dc._raise_on(err, "deformable conv backward", lib.selfc_deform_cuda_error_string)
    launches_bwd += 1
    dc._count((C, c_out), launches_bwd_by_width)
    return dx, doffset, dmask, dweight


# ---------------------------------------------------------------------------
# the public op: a CUDA tensor goes to the kernels or raises, a CPU tensor to
# the plain versions
# ---------------------------------------------------------------------------


class _DeformConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, mask, weight):
        out = (_forward_cuda if x.is_cuda else deform_conv2d_plain)(x, offset, mask, weight)
        ctx.save_for_backward(x, offset, mask, weight)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        bwd = _backward_cuda if x.is_cuda else deform_conv2d_bwd_plain
        return bwd(x, offset, mask, weight, g.contiguous())


def deform_conv2d(x, offset, mask, weight, bias=None):
    """The modulated deformable 3x3 conv, differentiable: x ``(N,H,W,C)``,
    offset ``(N,H,W,18)``, mask ``(N,H,W,9)``, weight ``(3,3,C,Cout)``, bias
    ``(Cout,)`` or None. On a CUDA tensor every operand must have x's dtype
    (float32 or bfloat16); the kernels take any shape, so nothing falls back
    to the composition there."""
    out = _DeformConv.apply(x.contiguous(), offset.contiguous(), mask.contiguous(),
                            weight.contiguous())
    return out if bias is None else out + bias
