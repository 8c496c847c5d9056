"""The standalone (3,1,1) temporal convolution with a fused bias and
LeakyReLU, and its gradient: the port's counterpart of
``selfc_tpu/ops/pallas_kernels.py``.

Replaces ``selfc_tpu/ops/pallas_kernels.py:_kernel`` (reached there through
``_tc3_impl`` and ``temporal_conv3_pallas``). The function, on a
channels-last video ``x (B,T,H,W,C)`` with ``w (3,C,Co)`` and ``b (Co,)``:

  y = x[t-1] @ w[0] + x[t] @ w[1] + x[t+1] @ w[2] + b     (zero pad in T)
  out = LeakyReLU(y, negative_slope)  or  y               (in fp32)

The JAX package runs it for the (3,1,1) convs at dilation 1 outside the
whole-chain kernels (``models/blocks.py:_ConvP``, kind 't'), when
``SELFC_TPU_PALLAS=1``; the port runs it there always. On a CUDA tensor
``temporal_conv3_fused`` launches the hand-written kernel of
``csrc/temporal_conv.cu`` or raises; there is no shape gate (the JAX wrapper
falls back to XLA at a ragged ``H*W``; the kernel takes every shape). On a
CPU tensor it runs the plain version below.

The gradient (an ``autograd.Function``): the LeakyReLU's mask is read off
the output where the slope is positive and saved by the forward otherwise (at
slope 0 the output cannot tell a negative input from 0); ``dx`` is the same
function again, launched with the weights ``[w2^T, w1^T, w0^T]`` and no bias;
``dw[k]`` and ``db`` are plain products and sums over the ``B*T*H*W`` rows, as
the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..kernels import build
from .conv import temporal_conv3

# this module keeps its own small launch helpers (dtype codes, stream,
# checks): ops/dense_chain.py imports it, so it cannot import that module
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# calls that went to the CUDA kernel, in all and by the forward's (C, Co):
# the forward, and the data gradient (one call each); and every call by its
# tile path and K split, (path, split) (a split call is two launches: the
# parts, then their fixed-order sum with the epilogue)
launches = 0
launches_by_width: dict = {}
launches_bwd = 0
launches_bwd_by_width: dict = {}
launches_by_path: dict = {}
# every call by ("forward" | "bwd", device index, W)
launches_by_device: dict = {}

# the kernel's tiles (csrc/temporal_conv.cu): Co <= NARROW_MAX_CO takes the
# narrow tile (256 rows, 8 or 16 columns), wider the wide one (128 rows, 48 or
# 64 columns: the one that pads Co less, 64 on a tie)
NARROW_MAX_CO = 16
_TILE_ROWS = {"narrow": 256, "wide": 128}
_WIDE_COLS = (64, 48)
MAX_SPLIT = 8
H100_SMS = 132   # the SM count a plan assumes for a CPU tensor (the rehearsal)


def reset_launch_counts():
    global launches, launches_bwd
    launches = launches_bwd = 0
    launches_by_width.clear()
    launches_bwd_by_width.clear()
    launches_by_path.clear()
    launches_by_device.clear()


def plan(B, T, S, C, Co, itemsize, sm_count):
    """``(path, split)`` of one launch: the narrow tile at Co <= 16, else
    the wide one; the K slabs (64 bytes of channels each) cut in 2, 4 or 8
    parts while the tiles do not fill ``sm_count`` SMs (at least two slabs
    a part). A block covers P pixels x all T frames of a clip (T above the
    tile's rows: a run of them), as the kernel tiles."""
    path = "narrow" if Co <= NARROW_MAX_CO else "wide"
    rows = _TILE_ROWS[path]
    tt, p = (T, rows // T) if T <= rows else (rows - 2, 1)
    cols = min(_WIDE_COLS, key=lambda n: (-(-Co // n) * n, -n))   # the wide tile that pads Co least
    tiles = B * -(-S // p) * -(-T // tt) * (1 if path == "narrow" else -(-Co // cols))
    nslab = -(-C // (64 // itemsize))
    split = 1
    while tiles * split < sm_count and split * 2 <= MAX_SPLIT and 2 * split * 2 <= nslab:
        split *= 2
    return path, split


@functools.lru_cache(maxsize=None)
def _device_sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(x):
    """The SMs a launch plans for: x's device's, an H100's for a CPU tensor."""
    if not x.is_cuda:
        return H100_SMS
    return _device_sms(x.device.index if x.device.index is not None else torch.cuda.current_device())


def _acc_dtype(t):
    """The type sums and the epilogue run in: fp32 (fp64 for fp64 input)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _flipped(w):
    """``(3,C,Co) -> (3,Co,C)``: ``[w2^T, w1^T, w0^T]``, the weights whose
    temporal conv of ``dy`` is ``dx``."""
    return w.flip(0).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _plain(x, w, b, negative_slope):
    """``(out, mask)``: the conv in fp32 (fp64 for fp64 input), rounded to
    x's dtype once, and ``y >= 0`` (None without a LeakyReLU)."""
    acc = _acc_dtype(x)
    y = temporal_conv3(x.to(acc), w.to(acc), None if b is None else b.to(acc))
    if negative_slope is None:
        return y.to(x.dtype), None
    mask = y >= 0
    return torch.where(mask, y, negative_slope * y).to(x.dtype), mask


def temporal_conv3_fused_plain(x, w, b=None, negative_slope=None):
    """Plain version of ``temporal_conv3_fused``, differentiable by autograd:
    the three shifted products and the LeakyReLU in fp32, the result in x's
    dtype, as in the kernel."""
    return _plain(x, w, b, negative_slope)[0]


def _weight_grad(x, dy):
    """``(dw (3,C,Co), db (Co,))`` of the conv for the output gradient
    ``dy``, in dy's dtype: ``dw[k] = sum_rows x[t+k-1]^T dy[t]``."""
    T, C, Co = x.shape[1], x.shape[-1], dy.shape[-1]
    xp = F.pad(x.to(dy.dtype), (0, 0, 0, 0, 0, 0, 1, 1))
    d2 = dy.reshape(-1, Co)
    dw = torch.stack([xp[:, k:k + T].reshape(-1, C).t() @ d2 for k in range(3)])
    return dw, d2.sum(0)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _library():
    """The kernel library, its C signatures set at the first call."""
    lib = build.load("temporal_conv")
    if lib.selfc_temporal_conv3.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.selfc_temporal_conv3.argtypes = [P] * 6 + [I] * 6 + [ctypes.c_float, I, I, I, P]
        lib.selfc_temporal_conv3.restype = I
        lib.selfc_temporal_conv3_cuda_error_string.argtypes = [I]
        lib.selfc_temporal_conv3_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _stream(x):
    """PyTorch's current stream on x's device, as an integer handle."""
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(name, t, shape, like):
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {like.dtype} on {like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _validate(x, w, b):
    """Raise on anything the kernel does not take: x ``(B,T,H,W,C)`` of
    float32 or bfloat16, w ``(3,C,Co)`` and b ``(Co,)`` (or None) of x's
    dtype on x's device, all contiguous."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"temporal conv kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x: expected (B,T,H,W,C), got shape {tuple(x.shape)}")
    if w.dim() != 3:
        raise ValueError(f"w: expected (3,C,Co), got shape {tuple(w.shape)}")
    _check("x", x, x.shape, x)
    _check("w", w, (3, x.shape[-1], w.shape[-1]), x)
    if b is not None:
        _check("b", b, (w.shape[-1],), x)


def _launch(x, w, b, negative_slope, want_mask, sm_count=None):
    """One call of the kernel: ``(out, mask)``, the mask (``y >= 0``, bool)
    only with ``want_mask``. The tile path and the K split are planned for
    ``sm_count`` SMs (default: x's device; a CPU tensor plans for an H100),
    and a split call gets its fp32 scratch here."""
    _validate(x, w, b)
    B, T, H, W, C = x.shape
    co = w.shape[-1]
    lib = _library()
    path, split = plan(B, T, H * W, C, co, x.element_size(), sm_count or _sm_count(x))
    out = torch.empty((B, T, H, W, co), dtype=x.dtype, device=x.device)
    mask = torch.empty(out.shape, dtype=torch.bool, device=x.device) if want_mask else None
    scratch = (torch.empty((split, B * T * H * W, co), dtype=torch.float32, device=x.device)
               if split > 1 else None)
    with build.on_device(x):
        err = lib.selfc_temporal_conv3(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
            None if mask is None else mask.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, T, H * W, C, co, int(negative_slope is not None),
            0.0 if negative_slope is None else float(negative_slope), _DTYPE_CODE[x.dtype],
            int(path == "wide"), split, _stream(x))
    if err != 0:
        raise RuntimeError(f"temporal conv kernel launch failed: "
                           f"{lib.selfc_temporal_conv3_cuda_error_string(err).decode()} ({err})")
    _count((path, split), launches_by_path)
    return out, mask


def _count(key, by_width):
    by_width[key] = by_width.get(key, 0) + 1


def _forward_cuda(x, w, b, negative_slope, want_mask, sm_count=None):
    global launches
    res = _launch(x, w, b, negative_slope, want_mask, sm_count)
    launches += 1
    _count((x.shape[-1], w.shape[-1]), launches_by_width)
    _count(("forward", x.device.index, x.shape[3]), launches_by_device)
    return res


def _data_grad_cuda(dy, w, sm_count=None):
    """dx for the output gradient ``dy`` (x's dtype): the kernel on ``dy``
    with the flipped weights, counted as a backward launch under the
    forward's (C, Co)."""
    global launches_bwd
    dx, _ = _launch(dy, _flipped(w), None, None, False, sm_count)
    launches_bwd += 1
    _count((w.shape[1], w.shape[-1]), launches_bwd_by_width)
    _count(("bwd", dy.device.index, dy.shape[3]), launches_by_device)
    return dx


# ---------------------------------------------------------------------------
# the public op: a CUDA tensor goes to the kernel or raises, a CPU tensor to
# the plain version
# ---------------------------------------------------------------------------


class _TemporalConv3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, negative_slope, save_mask, x, w, b):
        if x.is_cuda:
            out, mask = _forward_cuda(x, w, b, negative_slope, save_mask)
        else:
            out, mask = _plain(x, w, b, negative_slope)
        ctx.slope, ctx.has_bias = negative_slope, b is not None
        # the LeakyReLU's mask: read off the output at a positive slope
        keep = out if negative_slope is not None and negative_slope > 0 else mask
        ctx.save_for_backward(x, w, keep if negative_slope is not None else None)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, keep = ctx.saved_tensors
        ns = ctx.slope
        dy = g.to(_acc_dtype(x))
        if ns is not None:
            positive = keep >= 0 if ns > 0 else keep
            dy = torch.where(positive, dy, ns * dy)
        need_x = ctx.needs_input_grad[2]
        dx = None
        if need_x:
            dyx = dy.to(x.dtype).contiguous()
            dx = _data_grad_cuda(dyx, w) if x.is_cuda else _plain(dyx, _flipped(w), None, None)[0]
        dw, db = _weight_grad(x, dy)
        return (None, None, dx, dw.to(w.dtype),
                db.to(w.dtype) if ctx.has_bias else None)


def temporal_conv3_fused(x, w, b=None, negative_slope=None):
    """The (3,1,1) temporal conv of ``x (B,T,H,W,C)`` with ``w (3,C,Co)``
    and ``b (Co,)`` (or None), zero padded in T, and the LeakyReLU of slope
    ``negative_slope`` (None: none), differentiable. A CUDA tensor goes to
    the kernel (or raises on what it does not take: float32 or bfloat16
    only); a CPU tensor to the plain version. The parameters are cast to x's
    dtype first, outside the autograd function, so that gradients reach fp32
    master parameters through the cast."""
    dt = x.dtype
    w = w.to(dt)
    b = None if b is None else b.to(dt)
    slope = None if negative_slope is None else float(negative_slope)
    grads = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, b))
    save_mask = slope is not None and slope <= 0 and grads
    return _TemporalConv3.apply(slope, save_mask, x.contiguous(), w.contiguous(),
                                None if b is None else b.contiguous())
