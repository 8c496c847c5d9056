"""The D2DT dense chain with a fused coupling epilogue.

Replaces ``selfc_tpu/ops/pallas_chain.py:_chain_kernel_v2`` (reached there
through ``fused_dense_chain_t`` / ``fused_dense_chain_t_ep``). Forward only.

The function, on a channels-last video ``x (B,T,H,W,C)``:

  x_k = lrelu_0.2(conv3x3_SAME([x | x_1 .. x_{k-1}], w_k) + b_k),  k = 1..4
  y5  = temporal_conv3([x | x_1..x_4], w5) + b5          (zero pad in T)
  out = ep_apply(y5, mode, clamp, a, m)                  (in fp32)

with ``w_k (3,3,C+32(k-1),32)``, ``w5 (3,C+128,c_out)`` and the epilogue
operands ``a``, ``m`` of the output's shape.

On a CUDA tensor the work is done by the hand-written kernels of
``csrc/dense_chain.cu``. The chain is bound by arithmetic on the card, not
by bytes (a 64->64 chain does ~331k fp32 operations for each pixel and
moves under 1 KB of it), so the kernels trade device memory for arithmetic:
five launches write x_1..x_4 into channel slices of one preallocated
``(B,T,H,W,128)`` buffer (the concat is never assembled and no halo is
recomputed), each thread keeps an 8x8 register tile of plain fp32 FMAs fed
from a 16-channel slab in shared memory, and the epilogue is applied where
conv5's accumulator lives. No tensor cores and no TF32: fp32 stays fp32;
bf16 tensors are widened on load and rounded once on store.

On a CPU tensor, and only there, the wrapper takes the plain PyTorch
version below.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import build
from .conv import temporal_conv3

GC = 32  # growth channels the CUDA kernel is written for

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

# calls of dense_chain_t_ep that went to the CUDA kernels (one per call,
# whatever number of launches the call makes inside), in all and by
# (C, c_out)
launches = 0
launches_by_width: dict = {}


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


def dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode="none", clamp=1.0,
                           a=None, m=None):
    """Plain PyTorch version of the chain (any growth width). The epilogue
    runs in fp32 and the result returns in x's dtype, as in the kernel."""
    B, T, H, W, C = x.shape
    feats = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    for w, b in zip(ws, bs):
        y = F.conv2d(feats, w.to(x.dtype).permute(3, 2, 0, 1),
                     b.to(x.dtype), padding=1)
        feats = torch.cat([feats, F.leaky_relu(y, 0.2)], dim=1)
    cat = feats.permute(0, 2, 3, 1).reshape(B, T, H, W, -1)
    y5 = temporal_conv3(cat, w5.to(x.dtype), b5.to(x.dtype)).float()
    n_aux = EP_AUX[mode]
    aa = a.float() if n_aux >= 1 else None
    mm = m.float() if n_aux >= 2 else None
    return ep_apply(y5, mode, clamp, aa, mm).to(x.dtype)


def _library():
    """The dense-chain library, its C signatures set at the first call."""
    lib = build.load("dense_chain")
    fn = lib.selfc_dense_chain_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.selfc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.selfc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, like):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(
            f"{name}: {t.dtype} on {t.device}, expected {like.dtype} on "
            f"{like.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be aligned to 16 bytes (the kernels use vector loads)")


def _validate(x, ws, bs, w5, b5, mode, a, m):
    """Raise on anything the CUDA kernels do not take. Every tensor must be
    of x's dtype, on x's device, contiguous and aligned to 16 bytes."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"dense chain kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x: expected (B,T,H,W,C), got shape {tuple(x.shape)}")
    if len(ws) != 4 or len(bs) != 4:
        raise ValueError("the chain has four spatial convs")
    n_aux = EP_AUX[mode]
    aux = [t for t in (a, m)[:n_aux]]
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *ws, *bs, w5, b5, *aux) if isinstance(t, torch.Tensor)
    ):
        raise NotImplementedError(
            "the CUDA dense chain is forward-only: its backward kernels are "
            "ROADMAP items B2/B3; call it under torch.no_grad()"
        )
    B, T, H, W, C = x.shape
    c_out = w5.shape[-1]
    _check("x", x, x.shape, x)
    for k in range(4):
        _check(f"w{k + 1}", ws[k], (3, 3, C + GC * k, GC), x)
        _check(f"b{k + 1}", bs[k], (GC,), x)
    _check("w5", w5, (3, C + 4 * GC, c_out), x)
    _check("b5", b5, (c_out,), x)
    for name, t in zip("am", aux):
        _check(name, t, (B, T, H, W, c_out), x)
    if B * T > 65535:
        raise ValueError(f"B*T = {B * T} exceeds the kernel's grid limit 65535")


def _chain_cuda(x, ws, bs, w5, b5, mode, clamp, a, m):
    global launches
    _validate(x, ws, bs, w5, b5, mode, a, m)
    B, T, H, W, C = x.shape
    c_out = w5.shape[-1]
    n_aux = EP_AUX[mode]
    feats = torch.empty((B, T, H, W, 4 * GC), dtype=x.dtype, device=x.device)
    out = torch.empty((B, T, H, W, c_out), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.selfc_dense_chain_forward(
            x.data_ptr(), feats.data_ptr(),
            *(w.data_ptr() for w in ws), *(b.data_ptr() for b in bs),
            w5.data_ptr(), b5.data_ptr(),
            a.data_ptr() if n_aux >= 1 else None,
            m.data_ptr() if n_aux >= 2 else None,
            out.data_ptr(), B * T, T, H, W, C, c_out, _EP_CODE[mode],
            float(clamp), _DTYPE_CODE[x.dtype], stream,
        )
    if err != 0:
        msg = lib.selfc_cuda_error_string(err).decode()
        raise RuntimeError(f"dense chain kernel launch failed: {msg} ({err})")
    launches += 1
    launches_by_width[(C, c_out)] = launches_by_width.get((C, c_out), 0) + 1
    return out


def dense_chain_t_ep(x, ws, bs, w5, b5, mode="none", clamp=1.0, a=None,
                     m=None):
    """The chain with its epilogue. A CUDA tensor goes to the kernels (or
    raises on what they do not take); a CPU tensor to the plain version.
    Parameters are cast to x's dtype first (bf16 activations with fp32
    master parameters)."""
    if mode not in EP_AUX:
        raise ValueError(mode)
    if not x.is_cuda:
        return dense_chain_t_ep_plain(x, ws, bs, w5, b5, mode, clamp, a, m)
    dt = x.dtype
    return _chain_cuda(
        x, [w.to(dt) for w in ws], [b.to(dt) for b in bs], w5.to(dt),
        b5.to(dt), mode, clamp, a, m,
    )
