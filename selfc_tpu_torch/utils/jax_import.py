"""Carry parameters between the JAX package's tree and the port.

The port stores every parameter in the JAX package's layout and under its
tree names, so the bridge is a strict, rename-free copy: a nested (or flat,
dot-joined) dict of numpy arrays in the flax tree's shape goes into the
module's parameters. Reading the checkpoint file itself (flax msgpack) is
the caller's business — this module imports neither jax nor flax.
``export_jax_params`` / ``export_jax_grads`` go the other way: the
module's parameters, or their gradients, as a nested numpy tree under the
JAX names, so the two stacks can be compared leaf by leaf. A tree of
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


def load_jax_params(module: torch.nn.Module, tree) -> None:
    """Copy ``tree`` into ``module``'s parameters, in place. Raises
    ``KeyError`` on a missing or unexpected name and ``ValueError`` on a
    shape mismatch; nothing is copied unless everything matches."""
    flat = flatten_tree(tree)
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
    arrays = {k: np.asarray(v) for k, v in flat.items()}
    bad = [
        f"{k}: got {arrays[k].shape}, expected {tuple(p.shape)}"
        for k, p in params.items() if arrays[k].shape != tuple(p.shape)
    ]
    if bad:
        raise ValueError("parameter shapes differ: " + "; ".join(bad[:8]))
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(torch.tensor(arrays[k]).to(p.dtype))


def _nest(flat: dict) -> dict:
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
    return _nest({k: p.detach().float().cpu().numpy().copy()
                  for k, p in module.named_parameters()})


def export_jax_grads(module: torch.nn.Module) -> dict:
    """The parameters' ``.grad`` in the same tree (zeros where there is
    none)."""
    return _nest({k: (torch.zeros_like(p) if p.grad is None else p.grad)
                  .detach().float().cpu().numpy().copy()
                  for k, p in module.named_parameters()})
