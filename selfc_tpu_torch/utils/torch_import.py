"""Import a reference PyTorch ``.pth`` state dict into the JAX package's
parameter tree (the port's copy of ``selfc_tpu/utils/torch_import.py``).

The reference checkpoints (``{iter}_G.pth``) hold NCHW torch tensors; the
tree is channels-last with temporal convs stored as ``(3, Cin, Cout)``
matmuls. The kernel conversion is decided by the tensor's shape alone, the
name mapping by per-architecture rules. As the reference's loader does, a
``module.`` DDP prefix is stripped and the codec surrogate's keys are
skipped. Four rule sets: the SelfC_GMM (``gmm``), SelfC_GMM_Codec
(``codec``), Haar SelfC (``haar``) and IRN (``irn``) nets.

``export_state_dict`` goes the other way (the tree into a reference net's
state-dict layout, ``invert_tensor``), and ``import_vgg19_features`` reads a
torchvision VGG-19 ``features`` state dict into the perceptual loss's
feature extractor.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def convert_tensor(name: str, w: np.ndarray) -> np.ndarray:
    """torch kernel -> the tree's kernel, by shape."""
    w = np.asarray(w)
    if w.ndim == 5:  # Conv3d (Co, Ci, kt, kh, kw)
        kt, kh, kw = w.shape[2:]
        if (kt, kh, kw) == (1, 1, 1):
            return w[:, :, 0, 0, 0].T  # pointwise (Ci, Co)
        if kh == 1 and kw == 1:  # temporal (3,1,1)
            return w[:, :, :, 0, 0].transpose(2, 1, 0)  # (kt, Ci, Co)
        if kt == 1:  # spatial (1,kh,kw)
            return w[:, :, 0].transpose(2, 3, 1, 0)  # (kh, kw, Ci, Co)
        return w.transpose(2, 3, 4, 1, 0)  # full (kt,kh,kw,Ci,Co)
    if w.ndim == 4:  # Conv2d (Co, Ci, kh, kw)
        if w.shape[2] == 1 and w.shape[3] == 1:
            return w[:, :, 0, 0].T  # pointwise (Ci, Co)
        return w.transpose(2, 3, 1, 0)
    if w.ndim == 2:  # Linear (Co, Ci)
        return w.T
    return w  # biases etc.


def _set(tree: dict, path: list, value):
    d = tree
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


_GLOBALAGG_FIELDS = {
    "fc.weight": "fc_w",
    "fc.bias": "fc_b",
    "proj1.weight": "proj1_w",
    "proj1.bias": "proj1_b",
    "proj2.weight": "proj2_w",
    "proj2.bias": "proj2_b",
    "proj3.weight": "proj3_w",
    "proj3.bias": "proj3_b",
}


def _map_globalagg(rest: str):
    return [_GLOBALAGG_FIELDS[rest]]


_DEFORM_AGG_FIELDS = {
    "global_context_reallocator.0.weight": "realloc1_w",
    "global_context_reallocator.0.bias": "realloc1_b",
    "global_context_reallocator.2.weight": "realloc2_w",
    "global_context_reallocator.2.bias": "realloc2_b",
    "offset_conv.weight": "offset_w",
    "offset_conv.bias": "offset_b",
    "modulator_conv.weight": "modulator_w",
    "modulator_conv.bias": "modulator_b",
    "regular_conv.weight": "regular_w",
    "regular_conv.bias": "regular_b",
}


def _map_dense(rest: str):
    # "conv3.weight" -> ["chain", "conv3", "weight"]
    conv, leaf = rest.split(".")
    return ["chain", conv, leaf]


def _haar_block(idx: int, block_num):
    """The tree name of the coupling block at ``operations.{idx}`` of a Haar
    or IRN net: the operations run [haar, level 0's blocks, haar, level 1's
    blocks, ...], so a level's blocks sit at running indices past its Haar
    step."""
    start = 1
    for level, n in enumerate(block_num):
        if start <= idx < start + n:
            return f"level_blocks_{level}_{idx - start}"
        start += n + 1
    raise KeyError(f"operations.{idx} is no coupling block of block_num {tuple(block_num)}")


def map_reference_key(key: str, arch: str, block_num=(4, 4)):
    """Reference state-dict key -> its path in the tree (a list of str), or
    None to skip it. ``arch``: 'gmm', 'codec', 'haar' or 'irn'.
    ``block_num`` places the Haar and IRN nets' blocks."""
    key = re.sub(r"^module\.", "", key)
    if "Quantization_H265_Suggrogate" in key or "Quantization_H265" in key:
        return None  # the reference skips surrogate keys on load
    if "haar_weights" in key:
        return None  # fixed buffers, not parameters

    m = re.match(r"operations\.(\d+)\.([FGH])\.(.*)", key)
    if m:
        idx = int(m.group(1))
        # gmm / codec: operations.0 is the (parameter-free) FrequencyAnalyzer
        block = (f"inv_blocks_{idx - 1}" if arch in ("gmm", "codec")
                 else _haar_block(idx, block_num))
        return [block, m.group(2)] + _map_dense(m.group(3))

    m = re.match(r"stp_net\.(local_m\d)\.(.*)", key)
    if m:
        return ["stp_net", m.group(1)] + _map_dense(m.group(2))
    m = re.match(r"stp_net\.(global_m\d)\.(.*)", key)
    if m:
        return ["stp_net", m.group(1)] + _map_globalagg(m.group(2))
    m = re.match(r"stp_net\.other_stp_modules\.(\d+)\.(.*)", key)
    if m:
        n, rest = int(m.group(1)), m.group(2)
        if rest.startswith("conv"):
            return ["stp_net", f"other_local_{n // 2}"] + _map_dense(rest)
        return ["stp_net", f"other_global_{n // 2}"] + _map_globalagg(rest)
    m = re.match(r"stp_net\.(?:tail_gmm|tail)\.(\d+)\.(.*)", key)
    if m:
        seq_idx, leaf = int(m.group(1)), m.group(2)
        return ["stp_net", f"tail_{(seq_idx - 1) // 2}", leaf]
    # the Haar net's small prior
    m = re.match(r"stp_net\.blk1\.(\d+)\.(.*)", key)
    if m:
        return ["stp_net", f"blk1_{m.group(1)}"] + _map_dense(m.group(2))
    m = re.match(r"stp_net\.blk2\.(.*)", key)
    if m:
        return ["stp_net", "blk2"] + _map_dense(m.group(1))
    m = re.match(r"deart_net\.(\d+)\.(.*)", key)
    if m:
        n, rest = int(m.group(1)), m.group(2)
        if rest.startswith("conv"):
            return [f"deart_{n}"] + _map_dense(rest)
        if rest in _DEFORM_AGG_FIELDS:  # GroupedGlobalDeformAgg
            return [f"deart_{n}", _DEFORM_AGG_FIELDS[rest]]
        raise KeyError(f"unmapped deart_net key: {key}")
    raise KeyError(f"unmapped reference key: {key}")


def import_state_dict(state_dict, arch: str, block_num=(4, 4)) -> dict:
    """torch state dict (name -> tensor or array) -> the nested tree, fp32
    numpy leaves."""
    tree: dict = {}
    for k, v in state_dict.items():
        path = map_reference_key(k, arch, block_num)
        if path is None:
            continue
        arr = v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        _set(tree, path, np.asarray(convert_tensor(k, arr), np.float32))
    return tree


def load_pth(path: str, arch: str, block_num=(4, 4)) -> dict:
    """A reference ``.pth`` (a plain state dict, or one under
    ``state_dict``) -> the nested tree. Loaded with ``weights_only``: the
    file may hold tensors and containers, nothing that runs code."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return import_state_dict(sd, arch, block_num)


def invert_tensor(torch_shape, w: np.ndarray) -> np.ndarray:
    """The tree's kernel -> the torch kernel of ``torch_shape``
    (``convert_tensor``'s inverse, decided by the torch shape)."""
    w = np.asarray(w)
    if len(torch_shape) == 5:  # Conv3d (Co, Ci, kt, kh, kw)
        kt, kh, kw = torch_shape[2:]
        if (kt, kh, kw) == (1, 1, 1):
            return w.T[:, :, None, None, None]
        if kh == 1 and kw == 1:  # temporal: the tree's (kt, Ci, Co)
            return w.transpose(2, 1, 0)[:, :, :, None, None]
        if kt == 1:  # spatial: the tree's (kh, kw, Ci, Co)
            return w.transpose(3, 2, 0, 1)[:, :, None]
        return w.transpose(4, 3, 0, 1, 2)
    if len(torch_shape) == 4:  # Conv2d
        if torch_shape[2] == 1 and torch_shape[3] == 1:
            return w.T[:, :, None, None]
        return w.transpose(3, 2, 0, 1)
    if len(torch_shape) == 2:  # Linear
        return w.T
    return w


def _get(tree: dict, path: list):
    d = tree
    for k in path:
        d = d[k]
    return d


def export_state_dict(params: dict, template: dict, arch: str, block_num=(4, 4)) -> dict:
    """The tree -> a torch-layout state dict (numpy values), the inverse of
    ``import_state_dict``. ``template`` gives the keys and the tensor shapes
    (a reference net's ``state_dict()``); the keys the import skips (the
    fixed Haar buffers, the codec surrogate's) pass through from it
    unchanged. Raises ``ValueError`` when a converted shape differs from the
    template's."""
    out = {}
    for k, tv in template.items():
        tshape = tuple(tv.shape)
        path = map_reference_key(k, arch, block_num)
        if path is None:
            out[k] = np.asarray(tv.detach().cpu().numpy() if isinstance(tv, torch.Tensor) else tv)
            continue
        leaf = _get(params, path)
        ours = leaf.detach().cpu().float().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf, np.float32)
        conv = np.asarray(invert_tensor(tshape, ours), np.float32)
        if conv.shape != tshape:
            raise ValueError(f"{k}: exported shape {conv.shape} != template {tshape}")
        out[k] = conv
    return out


# torchvision's vgg19 ``features`` indices of its 16 convolutions
_VGG19_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)


def import_vgg19_features(state_dict) -> dict:
    """A torchvision vgg19 ``features.N.{weight,bias}`` state dict -> the
    feature extractor's tree ``{conv_i: {kernel (HWIO), bias}}``, up to the
    first conv it lacks. Raises ``KeyError`` when it has none."""
    out = {}
    for i, idx in enumerate(_VGG19_CONV_IDX):
        wk, bk = f"features.{idx}.weight", f"features.{idx}.bias"
        if wk not in state_dict:
            break
        w, b = state_dict[wk], state_dict[bk]
        w = w.detach().cpu().float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w, np.float32)
        b = b.detach().cpu().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
        out[f"conv_{i}"] = {"kernel": np.transpose(w, (2, 3, 1, 0)), "bias": b}
    if not out:
        raise KeyError("no vgg19 'features.N.weight' keys found")
    return out
