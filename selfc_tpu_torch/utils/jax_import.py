"""Carry parameters between the JAX package's tree and the port.

The port stores every parameter in the JAX package's layout and under its
tree names, so the bridge is a strict, rename-free copy: a nested (or flat,
dot-joined) dict of numpy arrays in the flax tree's shape goes into the
module's parameters (numpy leaves, or torch tensors: a bfloat16 leaf of a
checkpoint is one). Reading the checkpoint file itself is
``train/checkpoint.py``'s business.
``export_jax_params`` / ``export_jax_grads`` go the other way: the
module's parameters, or their gradients, as a nested numpy tree under the
JAX names, so the two stacks can be compared leaf by leaf. The JAX
package's ``scan_blocks`` nets stack their coupling blocks' leaves under
``scan_chain.blocks``; ``unstack_scan_chain`` / ``stack_scan_chain`` convert. A tree of
several top-level parts, as the codec's training keeps (``{net,
surrogate}``), goes into an ``nn.ModuleDict`` of modules under those keys.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a.b.c": leaf}; an already flat dict passes through."""
    flat = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_tree(v, name + "."))
        else:
            flat[name] = v
    return flat


def unstack_scan_chain(tree):
    """A tree of the JAX package's ``scan_blocks`` nets (the coupling blocks
    under ``scan_chain.blocks``, every leaf stacked along a leading block
    axis) -> the per-block tree ``inv_blocks_{i}`` the port's nets keep; any
    other tree passes through. Takes a nested or a flat (dot-joined) tree
    and returns the same kind."""
    flat = flatten_tree(tree)
    prefix = "scan_chain.blocks."
    stacked = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    if not stacked:
        return tree
    n = {int(v.shape[0]) for v in stacked.values()}
    if len(n) != 1:
        raise ValueError(f"scan_chain leaves stacked over different block counts: {sorted(n)}")
    out = {k: v for k, v in flat.items() if not k.startswith("scan_chain.")}
    for i in range(n.pop()):
        out.update({f"inv_blocks_{i}.{k}": v[i] for k, v in stacked.items()})
    nested = any(isinstance(v, dict) for v in tree.values())
    return nest_tree(out) if nested else out


def stack_scan_chain(tree: dict, n_blocks: int) -> dict:
    """The per-block nested tree -> the ``scan_blocks`` layout
    (``unstack_scan_chain``'s inverse; the JAX package's
    ``stack_block_params``)."""
    blocks = [flatten_tree(tree[f"inv_blocks_{i}"]) for i in range(n_blocks)]
    stacked = {k: np.stack([np.asarray(b[k]) for b in blocks], axis=0) for k in blocks[0]}
    out = {k: v for k, v in tree.items() if not k.startswith("inv_blocks_")}
    out["scan_chain"] = {"blocks": nest_tree(stacked)}
    return out


def load_jax_params(module: torch.nn.Module, tree) -> None:
    """Copy ``tree`` into ``module``'s parameters, in place (a stacked
    ``scan_blocks`` tree is unstacked first). Raises ``KeyError`` on a
    missing or unexpected name and ``ValueError`` on a shape mismatch;
    nothing is copied unless everything matches."""
    flat = flatten_tree(unstack_scan_chain(tree))
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    unexpected = sorted(set(flat) - set(params))
    if missing or unexpected:
        raise KeyError(
            f"parameter names differ: missing {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''} ({len(missing)}), "
            f"unexpected {unexpected[:8]}"
            f"{'...' if len(unexpected) > 8 else ''} ({len(unexpected)})"
        )
    arrays = {k: v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
              for k, v in flat.items()}
    bad = [
        f"{k}: got {tuple(arrays[k].shape)}, expected {tuple(p.shape)}"
        for k, p in params.items() if arrays[k].shape != p.shape
    ]
    if bad:
        raise ValueError("parameter shapes differ: " + "; ".join(bad[:8]))
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(arrays[k].to(p.dtype))


def nest_tree(flat: dict) -> dict:
    """{"a.b.c": leaf} -> the nested dict (``flatten_tree``'s inverse)."""
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def export_jax_params(module: torch.nn.Module) -> dict:
    """The module's parameters as a nested dict of fp32 numpy arrays
    (copies: a later step does not change them)."""
    return nest_tree({k: p.detach().float().cpu().numpy().copy()
                      for k, p in module.named_parameters()})


def export_jax_grads(module: torch.nn.Module) -> dict:
    """The parameters' ``.grad`` in the same tree (zeros where there is
    none)."""
    return nest_tree({k: (torch.zeros_like(p) if p.grad is None else p.grad)
                      .detach().float().cpu().numpy().copy()
                      for k, p in module.named_parameters()})
