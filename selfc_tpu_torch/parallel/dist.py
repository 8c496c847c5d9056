"""Processes and frames: the port's counterpart of the multi-process part
of the JAX package's ``parallel/mesh.py`` (``parallel/mesh.py`` holds the
device mesh within a process).

* ``init_distributed`` reads the torch launcher's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and joins the default
  process group over TCP: NCCL for CUDA, gloo for the CPU.
* With more than one process, a training step averages its gradients over
  them before the clip (``all_reduce_grads``): each rank holds
  ``batch_size // world_size`` clips and every loss is a mean over equal
  shares, so the step is one process's step on the concatenated batch. A
  step is skipped on every rank when any rank's loss is not finite
  (``finite_everywhere``).
* What is a statistic of the whole batch inside a loss (the discriminator's
  train-mode batch norm, 'ragan''s means, the codec surrogate's Pearson
  term) takes it over every process with
  ``global_mean``, on a differentiable sum (``all_reduce_sum``: the sum
  forward, the sum of the incoming gradients backward). Every rank must make
  the same calls in the same order, forward and backward.
* ``frames_to_device`` does the uint8 -> [0, 1] float32 cast on the device
  (the JAX package's ``put_frames``) for both model wrappers.

Each process runs its own ``(1, mesh_sp)`` row of cards
(``mesh.process_cards``): dp across processes is the gradient all-reduce
here. Only ``all_reduce`` is used: gloo reduces CUDA tensors with it, so two
processes may share one card over gloo (NCCL refuses two ranks on one
device).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def init_distributed(device=None, sp: int = 1):
    """``(rank, world_size)``. With ``WORLD_SIZE`` > 1 the default process
    group is initialised (NCCL when ``device`` is CUDA, else gloo) and a
    CUDA process takes the first of its ``sp`` cards, ``LOCAL_RANK`` (else
    ``RANK``) times ``sp``, modulo the cards it sees."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    cuda = torch.device(device or "cuda").type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) * sp % torch.cuda.device_count())
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", "8476")
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://{addr}:{port}",
                                world_size=world, rank=rank)
    return rank, world


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def all_reduce_grads(params) -> None:
    """Average the ``.grad`` of ``params`` over the processes, in one
    flattened all-reduce (nothing with one process). Every rank holds the
    same parameters with a gradient."""
    n = world_size()
    if n == 1:
        return
    import torch.distributed as dist

    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


class _AllReduceSum(torch.autograd.Function):
    """The sum over the processes; its adjoint is the sum over the
    processes of the incoming gradients."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x):
    """``x`` summed over the processes, differentiably; with one process
    ``x`` itself (no collective)."""
    return x if world_size() == 1 else _AllReduceSum.apply(x)


def global_mean(x, dims=None):
    """The mean of ``x`` over ``dims`` (all of them by default) and over
    every process's share, each share counted by its elements: the sums and
    the count in one all-reduce. With one process ``torch.mean`` itself."""
    if world_size() == 1:
        return torch.mean(x) if dims is None else torch.mean(x, dims)
    s = x.sum() if dims is None else x.sum(dims)
    n = x.new_full((1,), x.numel() // s.numel())
    total = all_reduce_sum(torch.cat([s.reshape(-1), n]))
    return (total[:-1] / total[-1]).reshape(s.shape)


def finite_everywhere(loss) -> bool:
    """Whether the loss is finite on every process (reads the device)."""
    ok = torch.isfinite(loss.detach()).to(torch.float32).reshape(1)
    if world_size() > 1:
        import torch.distributed as dist

        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    return bool(ok[0] > 0)


def frames_to_device(frames, device):
    """A host frame batch (numpy, float or uint8) as float32 on ``device``.
    uint8 crosses as uint8 (4x fewer bytes) and is cast to [0, 1] there, to
    within 1 ulp of the host's ``astype(float32) / 255``. A CUDA copy goes
    from pinned memory without blocking the host."""
    x = torch.from_numpy(np.ascontiguousarray(frames))
    if torch.device(device).type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    else:
        x = x.to(device)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
