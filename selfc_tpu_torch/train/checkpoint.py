"""Checkpoints with the JAX package's naming and files
(``selfc_tpu/train/checkpoint.py``), read and written without flax or optax.

* ``{iter}_G.msgpack``: the parameter tree under the JAX names, in flax's
  msgpack layout (``utils/flax_msgpack.py``); the JAX package reads the
  port's files and the port reads its. ``load_network`` also imports a
  reference ``.pth`` (``utils/torch_import.py``).
* ``{iter}.state``: a pickle of ``{epoch, iter, opt_state, extra}``. The
  JAX package's ``opt_state`` is optax's chain state, a tuple holding one
  ``ScaleByAdamState(count, mu, nu)`` among ``EmptyState``s (clip and
  weight decay keep none); ``load_training_state`` reads it through an
  unpickler that maps those two optax classes to stand-ins here and lets
  only numpy's own names through besides. The port writes the same chain
  state (``optax_adam_state``), pickled under optax's names, so the JAX
  package's ``resume_training`` reads it; it still reads its older states,
  plain ``opt_state: {count, mu, nu}``.
  ``mu`` and ``nu`` are trees under the parameter names, or (the JAX
  package's ``train.fused_optimizer``) one flat vector each in
  ``ravel_pytree`` order: the tree's leaves with the keys sorted at every
  level.

Both files are published atomically: written to ``.tmp``, then renamed,
so a reader never sees half a checkpoint.
"""

from __future__ import annotations

import importlib.util
import io
import os
import pickle
from typing import Any, NamedTuple

import numpy as np
import torch

from ..utils.flax_msgpack import msgpack_restore, msgpack_serialize
from ..utils.jax_import import flatten_tree, nest_tree, unstack_scan_chain
from ..utils.torch_import import load_pth


def _publish(path: str, data: bytes) -> None:
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def save_network(tree, model_dir: str, iter_label, network_label: str = "G") -> str:
    """Write the parameter tree (numpy or torch leaves) as
    ``{model_dir}/{iter_label}_{network_label}.msgpack``."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"{iter_label}_{network_label}.msgpack")
    _publish(path, msgpack_serialize(tree))
    return path


def read_msgpack(path: str):
    """The tree of a flax msgpack file (numpy leaves over one buffer)."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    return msgpack_restore(buf)


def load_network(path: str, template, arch: str = "gmm", block_num=(4, 4)):
    """A msgpack checkpoint (a ``scan_blocks`` net's unstacked) or a
    reference ``.pth`` merged into the template tree (``merge``)."""
    if path.endswith(".pth"):
        return merge(template, load_pth(path, arch, block_num))
    return merge(template, unstack_scan_chain(read_msgpack(path)))


def merge(template, loaded):
    """The template tree with the loaded tree's leaves put in: a key the
    checkpoint lacks keeps the template's value (the reference's
    ``strict_load=False``), a key the template lacks raises ``KeyError``, a
    shape that differs ``ValueError``."""
    flat_t = flatten_tree(template)
    flat_l = flatten_tree(loaded)
    unknown = set(flat_l) - set(flat_t)
    if unknown:
        raise KeyError(f"checkpoint keys not in model: {sorted(unknown)[:5]} ...")
    out = dict(flat_t)
    for k, v in flat_l.items():
        if tuple(v.shape) != tuple(flat_t[k].shape):
            raise ValueError(
                f"shape mismatch at {k}: ckpt {tuple(v.shape)} vs model {tuple(flat_t[k].shape)}")
        out[k] = v
    return nest_tree(out)


# ---------------------------------------------------------------------------
# training state
# ---------------------------------------------------------------------------


class EmptyState(NamedTuple):
    """Stand-in for ``optax._src.base.EmptyState``."""


class ScaleByAdamState(NamedTuple):
    """Stand-in for ``optax._src.transform.ScaleByAdamState``."""
    count: Any
    mu: Any
    nu: Any


_STANDINS = {("optax._src.base", "EmptyState"): EmptyState,
             ("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState}
# numpy 2 pickles name numpy._core, which numpy 1 calls numpy.core
_NUMPY_CORE = "numpy._core" if importlib.util.find_spec("numpy._core") else "numpy.core"


class _StateUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _STANDINS:
            return _STANDINS[module, name]
        if module == "numpy" or module.startswith("numpy."):
            if module.startswith(("numpy._core", "numpy.core")):
                module = _NUMPY_CORE + module.split("core", 1)[1]
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} has no place in a training state")


class _OptaxNamesPickler(pickle._Pickler):
    """Pickles the stand-ins under optax's own names, so that the JAX
    package's plain ``pickle.load`` gives it optax's classes (the Python
    pickler: its ``save_global`` can be taken over)."""

    def save_global(self, obj, name=None):
        for (module, qualname), cls in _STANDINS.items():
            if obj is cls:
                if self.proto >= 4:
                    self.save(module)
                    self.save(qualname)
                    self.write(pickle.STACK_GLOBAL)
                else:
                    self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
                self.memoize(obj)
                return
        super().save_global(obj, name)


def _dumps(payload) -> bytes:
    buf = io.BytesIO()
    _OptaxNamesPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
    return buf.getvalue()


def save_training_state(state_dir: str, epoch: int, it: int, opt_state, extra=None) -> str:
    """Write ``{state_dir}/{it}.state``; ``opt_state`` (and any optax chain
    state in ``extra``) as ``optax_adam_state`` gives it, written under
    optax's names."""
    os.makedirs(state_dir, exist_ok=True)
    path = os.path.join(state_dir, f"{it}.state")
    payload = {"epoch": int(epoch), "iter": int(it), "opt_state": opt_state, "extra": extra or {}}
    _publish(path, _dumps(payload))
    return path


def load_training_state(path: str) -> dict:
    """The payload of a ``.state`` file, the JAX package's or the port's."""
    with open(path, "rb") as f:
        return _StateUnpickler(f).load()


def adam_moments(opt_state):
    """``(count, mu, nu)`` of a saved optimizer state: the port's dict, or
    the one ``ScaleByAdamState`` of an optax chain's tuple, found by its
    type (the chain's length depends on the clip and weight-decay
    options)."""
    if isinstance(opt_state, dict):
        return int(opt_state["count"]), opt_state["mu"], opt_state["nu"]
    adam = [s for s in opt_state if isinstance(s, ScaleByAdamState)]
    if len(adam) != 1:
        raise ValueError(f"an optimizer state with {len(adam)} Adam states")
    return int(np.asarray(adam[0].count)), adam[0].mu, adam[0].nu


def unravel(vec, shapes: dict) -> dict:
    """A flat vector -> ``{name: array}`` in ``ravel_pytree`` order: the
    names sorted by their path, key by key."""
    vec = np.asarray(vec)
    names = sorted(shapes, key=lambda n: n.split("."))
    sizes = [int(np.prod(shapes[n])) for n in names]
    if vec.shape != (sum(sizes),):
        raise ValueError(f"a flat moment vector of shape {vec.shape} for {sum(sizes)} parameters")
    out, at = {}, 0
    for n, size in zip(names, sizes):
        out[n] = vec[at:at + size].reshape(shapes[n])
        at += size
    return out


def adam_state(optimizer: torch.optim.Adam, named_params) -> dict:
    """``{count, mu, nu}`` of a ``torch.optim.Adam`` under the parameter
    names (before its first step: count 0 and zero moments, as optax's
    ``init``)."""
    count, mu, nu = 0, {}, {}
    for name, p in named_params:
        st = optimizer.state.get(p) or {}
        if "step" in st:
            count = int(st["step"])
        mu[name] = (st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p)).detach().float().cpu().numpy()
        nu[name] = (st["exp_avg_sq"] if "exp_avg_sq" in st else torch.zeros_like(p)).detach().float().cpu().numpy()
    return {"count": count, "mu": nest_tree(mu), "nu": nest_tree(nu)}


def optax_adam_state(optimizer: torch.optim.Adam, named_params, clip=None, weight_decay=None,
                     stack=None) -> tuple:
    """A ``torch.optim.Adam``'s state as the state of the JAX package's optax
    chain ``[clip_by_global_norm(clip)] [add_decayed_weights(weight_decay)]
    scale_by_adam``: an ``EmptyState()`` for each of the first two that is
    set, then ``ScaleByAdamState(count, mu, nu)`` with an int32 count and the
    moments nested as the parameter tree (``stack``: a function applied to
    each moment tree, e.g. ``stack_scan_chain`` for a ``scan_blocks`` net).
    ``save_training_state`` writes it under optax's names."""
    st = adam_state(optimizer, named_params)
    mu, nu = (st[k] if stack is None else stack(st[k]) for k in ("mu", "nu"))
    return (EmptyState(),) * (bool(clip) + bool(weight_decay)) + (
        ScaleByAdamState(np.asarray(st["count"], np.int32), mu, nu),)


def restore_adam(optimizer: torch.optim.Adam, named_params, opt_state) -> int:
    """Put a saved state's moments and step into a ``torch.optim.Adam``:
    mu -> exp_avg, nu -> exp_avg_sq, count -> step, by parameter name, on
    the parameter's device. Returns the step. Raises ``KeyError`` when the
    names differ, ``ValueError`` when a shape does."""
    named = dict(named_params)
    count, mu, nu = adam_moments(opt_state)
    shapes = {k: tuple(p.shape) for k, p in named.items()}
    moments = []
    for m in (mu, nu):
        flat = flatten_tree(unstack_scan_chain(m)) if isinstance(m, dict) else unravel(m, shapes)
        if set(flat) != set(named):
            raise KeyError(f"moment names differ from the parameters': {sorted(set(flat) ^ set(named))[:5]}")
        bad = [k for k in named if tuple(np.shape(flat[k])) != shapes[k]]
        if bad:
            raise ValueError(f"moment shapes differ at {bad[:5]}")
        moments.append(flat)
    group_of = {p: g for g in optimizer.param_groups for p in g["params"]}
    for k, p in named.items():
        g = group_of[p]
        # where torch.optim.Adam keeps its step: on the device only when
        # capturable or fused
        on = p.device if (g.get("capturable") or g.get("fused")) else "cpu"
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32, device=on),
            "exp_avg": torch.as_tensor(np.array(moments[0][k]), dtype=p.dtype, device=p.device),
            "exp_avg_sq": torch.as_tensor(np.array(moments[1][k]), dtype=p.dtype, device=p.device),
        }
    return count
