"""Test-time codec streaming pipeline (the compression eval).

Reproduces the reference's streaming eval (SelfC_Codec_arch_inv.forward_test,
SelfC_Codec_arch_inv.py:502-640), as the JAX package's ``codec/pipeline.py``
does:

  * pad T to a multiple of Seg_Len = 3 by repeating the second-to-last frame
    (``seg_add_pad``, reference utils/util.py:329-345),
  * ENCODE per segment on the device with the width split in half
    (:537-542), write the LR frames into one live x265 stream,
  * close the stream -> file-size bpp, read the decoded LR frames back,
  * DECODE per segment with 2x2 spatial tiling (:594-624).

The whole video stays on the host; only a group of segments lives on the
device. On top of the reference's semantics, three options, on by default:

  * ``batch_tiles``: the width halves / 2x2 tiles are independent and of one
    shape, so they ride the batch axis of one encode / one decode call
    (convolutions never cross the batch axis: the same numbers per tile);
  * ``seg_batch``: G segments batch into one call (a segment's temporal
    receptive field ends at its edges, so segments are independent too);
  * ``overlap``: the host codec write of group i runs while the device
    encodes group i+1. A device result's copy to pinned host memory is
    enqueued as soon as its call returns, right behind the kernels that
    make it, with an event after it; the host reads it only after the next
    group's launches are enqueued and waits for that event alone. The same
    on the decode side.

``batch_tiles=False, seg_batch=1, overlap=False`` is the reference's
strictly serial call pattern. ``encode_fn`` / ``decode_fn`` may return
numpy arrays or torch tensors (CPU or CUDA); every result reaches the host
through ``to_host`` or ``_Pending``.
"""

from __future__ import annotations

import numpy as np
import torch

from .h265 import make_stream


def to_host(t) -> np.ndarray:
    """A device function's result as a numpy array (a CUDA tensor is
    copied, which waits for the kernels that make it)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class _Pending:
    """A result on its way to the host. For a CUDA tensor the copy into
    pinned host memory is enqueued at once, on the current stream, so it
    waits only for the kernels launched before it; ``get`` waits for that
    copy alone."""

    def __init__(self, out):
        self._done = None
        if isinstance(out, torch.Tensor) and out.is_cuda:
            self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host = out

    def get(self) -> np.ndarray:
        if self._done is None:
            return to_host(self._host)
        self._done.synchronize()
        return self._host.numpy()


def seg_add_pad(video: np.ndarray, seg_len: int):
    """(B,T,...) -> (B, n_seg, seg_len, ...), pad count. Pads by repeating
    the second-to-last frame (reference utils/util.py:341-342)."""
    B, T = video.shape[:2]
    pad = (seg_len - T % seg_len) % seg_len
    if pad:
        filler = np.repeat(video[:, -2:-1], pad, axis=1)
        video = np.concatenate([video, filler], axis=1)
    n_seg = video.shape[1] // seg_len
    return video.reshape(B, n_seg, seg_len, *video.shape[2:]), pad


def seg_remove_pad(video: np.ndarray, pad: int, seg_len: int):
    """(B, n_seg, seg_len, ...) -> (B, T, ...)."""
    B, n_seg = video.shape[:2]
    flat = video.reshape(B, n_seg * seg_len, *video.shape[3:])
    if pad:
        flat = flat[:, :n_seg * seg_len - pad]
    return flat


def _group_indices(n_seg: int, G: int):
    """Yield (segment indices, n_real) per call; the last group is padded by
    repeating its final segment, so every call has one shape."""
    for s in range(0, n_seg, G):
        idx = list(range(s, min(s + G, n_seg)))
        n_real = len(idx)
        idx += [idx[-1]] * (G - n_real)
        yield idx, n_real


def compress_video(
    encode_fn,
    decode_fn,
    video: np.ndarray,
    q,
    keyint,
    scale: int,
    h265_all_default: bool = False,
    seg_len: int = 3,
    divide_width_num: int = 2,
    divide_height_num: int = 2,
    batch_tiles: bool = True,
    seg_batch: int = 1,
    overlap: bool = True,
    stand_in: str | None = None,
):
    """Full streaming compression roundtrip.

    encode_fn(chunk (B,seg,H,W,3) numpy) -> latent (B,seg,h,w,C), whose
    first 3 channels are the LR; decode_fn(lr_tile (B,seg,hd,wd,3) numpy)
    -> HR tile (B,seg,hd*s,wd*s,3). Returns (lr_decoded (B,T,h,w,3),
    hr (B,T,H,W,3), video_bpp). With ``batch_tiles`` the width halves
    (encode) / 2x2 tiles (decode) ride the batch axis of one call;
    ``seg_batch`` groups that many segments a call; ``overlap`` defers each
    group's readback until the next group is enqueued. All three keep the
    numbers of every tile (batch entries are independent).
    """
    B, T, H, W, _ = video.shape
    segs, pad = seg_add_pad(video, seg_len)
    n_seg = segs.shape[1]
    dw, dh = divide_width_num, divide_height_num
    G = max(1, int(seg_batch)) if batch_tiles else 1

    stream = make_stream(q, keyint, scale, h265_all_default, stand_in=stand_in)
    stream.open_writer(W // scale, H // scale)

    wd = W // dw

    def _write_lr(y_seg):
        """y_seg: latent (B, seg, h, w, C) of ONE segment -> stream."""
        lr = y_seg[..., :3]
        stream.write_multi_frames(lr.reshape(B * seg_len, H // scale, W // scale, 3))

    if not batch_tiles:
        # the reference's serial loop: one call per (segment, width half)
        for si in range(n_seg):
            chunk = segs[:, si]  # (B, seg, H, W, 3)
            outs = [to_host(encode_fn(chunk[:, :, :, i * wd:(i + 1) * wd]))
                    for i in range(dw)]
            _write_lr(np.concatenate(outs, axis=3))
    else:
        pending = None  # (n_real, _Pending latents)

        def _flush_encode(p):
            n_real, y_dev = p
            y = y_dev.get()  # (G*dw*B, seg, h, wl, C)
            y = y.reshape(G, dw * B, *y.shape[1:])
            for g in range(n_real):
                halves = y[g].reshape(dw, B, *y.shape[2:])
                _write_lr(np.concatenate(list(halves), axis=3))

        for idx, n_real in _group_indices(n_seg, G):
            parts = [segs[:, si, :, :, i * wd:(i + 1) * wd] for si in idx for i in range(dw)]
            y_dev = _Pending(encode_fn(np.concatenate(parts, axis=0)))
            if pending is not None:
                _flush_encode(pending)  # the host write overlaps the device encode
            pending = (n_real, y_dev)
            if not overlap:
                _flush_encode(pending)
                pending = None
        if pending is not None:
            _flush_encode(pending)

    video_bpp = stream.close_writer()

    stream.open_reader()
    decoded = []
    for _ in range(n_seg):
        fr = stream.read_multi_frames(B * seg_len)
        decoded.append(fr.reshape(B, seg_len, H // scale, W // scale, 3))
    stream.close_reader()
    lr_dec_segs = np.stack(decoded, axis=1)  # (B, n_seg, seg, h, w, 3)
    lr_decoded = seg_remove_pad(lr_dec_segs, pad, seg_len)

    h, w = H // scale, W // scale
    hd, wdl = h // dh, w // dw
    hr_out = np.empty((B, n_seg, seg_len, H, W, 3), video.dtype)

    if not batch_tiles:
        for si in range(n_seg):
            lr_seg = lr_dec_segs[:, si]  # (B, seg, h, w, 3)
            rows = []
            for ti in range(dh):
                cols = [to_host(decode_fn(lr_seg[:, :, ti * hd:(ti + 1) * hd,
                                                 tj * wdl:(tj + 1) * wdl]))
                        for tj in range(dw)]
                rows.append(np.concatenate(cols, axis=3))
            hr_out[:, si] = np.concatenate(rows, axis=2)
    else:
        pending = None  # (idx, n_real, _Pending tiles)

        def _flush_decode(p):
            idx, n_real, hr_dev = p
            t = hr_dev.get()  # (G*dh*dw*B, seg, hd*s, wd*s, 3)
            t = t.reshape(G, dh, dw, B, *t.shape[1:])
            for g in range(n_real):
                rows = [np.concatenate(list(t[g, ti]), axis=3) for ti in range(dh)]
                hr_out[:, idx[g]] = np.concatenate(rows, axis=2)

        for idx, n_real in _group_indices(n_seg, G):
            tiles = [lr_dec_segs[:, si, :, ti * hd:(ti + 1) * hd, tj * wdl:(tj + 1) * wdl]
                     for si in idx for ti in range(dh) for tj in range(dw)]
            hr_dev = _Pending(decode_fn(np.concatenate(tiles, axis=0)))
            if pending is not None:
                _flush_decode(pending)
            pending = (idx, n_real, hr_dev)
            if not overlap:
                _flush_decode(pending)
                pending = None
        if pending is not None:
            _flush_decode(pending)

    hr = seg_remove_pad(hr_out, pad, seg_len)
    return lr_decoded, hr, video_bpp
