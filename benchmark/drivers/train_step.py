"""The training step of the 4x net on the program's own loader: the pack
of rendered clips is written for the program's packed dataset under
``TMPDIR``, its ``DataLoader`` crops, flips and rotates batches of uint8
clips as the configuration's ``datasets.train`` says (``video_len``,
``GT_size``, ``use_flip``, ``use_rot``, ``use_shuffle``, ``n_workers``),
and each step is ``feed_data`` -> ``optimize_parameters(step, eps)`` with
the prior's noise from a pool drawn from the seed. On one card a step
takes the configuration's whole ``batch_size``. A cell on several cards
runs a rank a card, each on its own share of the set and stepping the
share of one of the configuration's ``gpu_ids`` (``batch_size /
len(gpu_ids)`` clips), so the global batch grows with the cards
(``parallel/dist.py`` averages the gradients); rank 0 reports.

Set-up builds the model once and drives it through its first three steps
on the window's own loader and call; that same model then runs the window.
``correct``: once the window has closed, the plain reference (fp32, TF32
off) follows those three steps from the same weights on the same batches
(every rank's, for the global batch) and noise, and the numbers compared
are each step's loss, the first gradient as the optimiser took it (read
from Adam's first moment after one step), its worst leaf, and the change
of the leaves after the three steps, its median leaf (leaves whose
reference gradient is under a thousandth of the median leaf's are left
out): a leaf's gap of norms is taken against its own reference norm or
the median leaf's, the larger. The change is held by its median leaf, not
its worst: Adam moves every element by about lr whatever its gradient, so
in a leaf whose gradient is small beside the median leaf's (the
aggregations' ``fc_w``, a few biases) round-off alone turns elements'
steps, and the worst leaf reads as high in sound runs as in the control.
The batches are held to the packed set: each row a crop of its named clip,
flipped or turned, and no two rows alike."""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from torch.profiler import record_function

from .. import faults
from ..harness import sub_seed, traced
from ..traffic import generate

N_CHECKED = 3
MOVED = 1e-3      # a leaf moves where its reference gradient is at least this share of the median leaf's


def batch_per_rank(run):
    """The clips one rank steps: the configuration's whole ``batch_size``
    on one card, the share of one of its ``gpu_ids`` on each of several."""
    dt = run.cfg["datasets"]["train"]
    return dt["batch_size"] if run.world == 1 else dt["batch_size"] // len(run.cfg["gpu_ids"])


def work(r):
    """One step of one rank's batch: the roundtrip's chain forward and
    adjoint, and three times its forward's products."""
    k, dt = r.cfg["scale"], r.cfg["datasets"]["train"]
    w = r.work_model.roundtrip_work(r.cfg, (batch_per_rank(r), dt["video_len"], dt["GT_size"] // k,
                                            dt["GT_size"] // k))
    w["ops"] *= 3.0
    return w


class _Named:
    def __init__(self, params):
        self.params = params

    def named_parameters(self):
        return iter(self.params.items())


def _mean_over_ranks(grads):
    import torch.distributed as dist

    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


class Control:
    """``RescaleModel``'s training calls, by the plain reference in TF32;
    across ranks the gradients are averaged before the clip, as the
    program averages them."""

    def __init__(self, run, tree):
        self.ref, self.dev = run.ref, run.device
        self.trainer = run.ref.Trainer(tree, run.cfg, run.cfg["train"], _mean_over_ranks if run.world > 1 else None)
        self.net, self.optimizer = _Named(self.trainer.params), self.trainer.opt

    def feed_data(self, data):
        self.hr = torch.from_numpy(np.ascontiguousarray(data["GT"])).to(self.dev).float() / 255.0

    def optimize_parameters(self, step, eps):
        with self.ref.precision(True):
            self.loss, _ = self.trainer.step(self.hr, eps)

    def get_current_log(self):
        return {"loss": self.loss}


FAULTS = (faults.AlteredAnswer, faults.FrozenState, faults.HalfBatch)
RANK_FAULTS = (faults.NoExchange,)     # the faults a cell over several ranks can have besides


def program(run, tree):
    """The port's training model with the benchmark's weights."""
    from selfc_tpu_torch.config import dict_to_nonedict
    from selfc_tpu_torch.train.rescale_model import RescaleModel

    cfg, dt = run.cfg, run.cfg["datasets"]["train"]
    opt = dict_to_nonedict({
        "model": cfg["model"], "scale": cfg["scale"], "distortion": cfg["distortion"], "is_train": True,
        "datasets": {"train": {"video_len": dt["video_len"], "batch_size": batch_per_rank(run) * run.world,
                               "GT_size": dt["GT_size"]}},
        "network_G": cfg["network_G"], "train": cfg["train"]})
    model = RescaleModel(opt, device=run.device)
    model.load_jax_params(tree)
    return model


def loader(run, root):
    """The program's loader over the packed set at ``root``, as the
    configuration's ``datasets.train`` sets it: this rank's share,
    ``batch_per_rank`` clips a batch, the items' crops and flips keyed by a
    seed drawn from the run's."""
    from selfc_tpu_torch.config import dict_to_nonedict
    from selfc_tpu_torch.data import DistIterSampler, create_dataloader, create_dataset

    dopt = dict_to_nonedict({
        **run.cfg["datasets"]["train"], "phase": "train", "mode": "LQGTVID_packed", "dataroot_GT": root,
        "batch_size": batch_per_rank(run) * run.world, "output_uint8": True, "rng_seed": sub_seed(run.seed, 4),
        "epoch_ratio": run.mix["epoch_ratio"]})
    ds = create_dataset(dopt)
    sampler = DistIterSampler(len(ds), run.world, run.rank, 1) if run.world > 1 else None
    return create_dataloader(ds, dopt, {"world_size": run.world}, sampler)


def batches(ld):
    while True:
        yield from ld


def eps_pool(run, rank, device):
    """The prior's noise of rank ``rank``'s steps: ``pool`` tensors drawn
    from the seed; step s takes entry s mod ``pool``."""
    k, dt = run.cfg["scale"], run.cfg["datasets"]["train"]
    shape = (batch_per_rank(run), dt["video_len"], dt["GT_size"] // k, dt["GT_size"] // k, 3 * k * k,
             run.cfg["network_G"]["gmm_k"])
    g = torch.Generator(device=device).manual_seed(sub_seed(run.seed, 5, rank))
    return [torch.randn(shape, generator=g, device=device) for _ in range(run.mix["eps_pool"])]


def _leaf_norms(tensors):
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).tolist()


def run(r):
    clips = generate.packed_clips(r.mix, r.seed, r.cfg["datasets"]["train"]["video_len"])
    r.mark("traffic")
    tmp = tempfile.TemporaryDirectory()
    try:
        from selfc_tpu_torch.data.packed import write_packed

        write_packed(os.path.join(tmp.name, "set"), clips)
        ld = loader(r, os.path.join(tmp.name, "set"))
        r.mark("packed")
        try:
            return _run(r, clips, ld)
        finally:
            ld.close()
    finally:
        tmp.cleanup()


def _run(r, clips, ld):
    import torch.distributed as dist

    mix = r.mix
    tree = r.weights()
    model = (r.make_program or program)(r, tree)
    eps = eps_pool(r, r.rank, r.device)
    r.mark("program")
    it = batches(ld)
    beta1 = r.cfg["train"]["beta1"]
    names = [n for n, _ in model.net.named_parameters()]
    fed, losses = [], []
    for s in range(N_CHECKED):
        b = next(it)
        model.feed_data({"GT": b["GT"]})
        model.optimize_parameters(s, eps=eps[s % len(eps)])
        losses.append(model.get_current_log()["loss"])
        if s == 0:
            # Adam's first moment after one step is (1 - beta1) times the gradient it took
            state = model.optimizer.state
            g1 = _leaf_norms([state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in state[p] else torch.zeros_like(p)
                              for _, p in model.net.named_parameters()])
        fed.append((b["GT"], list(b["LQ_path"])))
        r.mark(f"step{s}")
    p3 = {n: p.detach().clone() for n, p in model.net.named_parameters()}
    if r.world > 1:
        fed, losses = _gather(r, fed, losses)

    def go_on(t_end, i, n_units):
        if n_units:
            return i < n_units
        if r.world == 1:
            return time.perf_counter() < t_end
        # every rank stops after the same step: rank 0's clock decides
        flag = torch.tensor([time.perf_counter() < t_end], device=r.device)
        dist.broadcast(flag, 0)
        return bool(flag.item())

    out = {"work": work(r)}
    wait = 0.0

    def loop(start, n_units, t_end):
        nonlocal wait
        wait, i = 0.0, 0
        while go_on(t_end, i, n_units):
            tw = time.perf_counter()
            with record_function("bench.next_batch"):
                b = next(it)
            wait += time.perf_counter() - tw
            with record_function("bench.step"):
                model.feed_data({"GT": b["GT"]})
                model.optimize_parameters(start + i, eps=eps[(start + i) % len(eps)])
            i += 1
        r.sync()
        return i, time.perf_counter()

    t0 = r.window_open()
    if r.trace:
        # the steps' wall time untraced, then the same number of steps traced
        n_units = mix["traced_units"]
        steps, t1 = loop(N_CHECKED, n_units, None)
        with traced(r) as tr:
            _, t_last = loop(N_CHECKED + steps, n_units, None)
        out.update(attr=tr["attr"], units=steps, wall_s=t1 - t0, traced_wall_s=t_last - t1 - tr["start_s"],
                   data_wait_s=wait)
    else:
        steps, t_last = loop(N_CHECKED, None, t0 + r.seconds)
        out["e2e"] = {"train_clips_per_s": steps * batch_per_rank(r) * r.world / (t_last - t0)}
        r.info(steps=steps, window_s=t_last - t0, data_wait_s=wait, last_loss=model.get_current_log()["loss"])
    out["memory_peak_bytes"] = r.peak_bytes()
    out["attempted"], out["failed"] = steps, 0
    del model
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    if r.rank == 0:
        out["checks"] = check(r, tree, clips, fed, losses, dict(zip(names, g1)), p3)
    return out


def _gather(r, fed, losses):
    """Every rank's three batches and losses on rank 0: the global batch of
    each step in rank order, and each step's mean loss."""
    import torch.distributed as dist

    glob = []
    for gt, paths in fed:
        t = torch.from_numpy(np.ascontiguousarray(gt)).to(r.device)
        parts = [torch.empty_like(t) for _ in range(r.world)]
        dist.all_gather(parts, t)
        names = [None] * r.world
        dist.all_gather_object(names, paths)
        glob.append((torch.cat(parts).cpu().numpy(), [n for ns in names for n in ns]))
    every = [None] * r.world
    dist.all_gather_object(every, losses)
    return glob, [float(np.mean([e[s] for e in every])) for s in range(len(losses))]


def check(r, tree, clips, fed, losses, g1, p3, tf32=False):
    """The compared numbers: ``{name: value}``."""
    dev = r.device
    data_faults = _data_faults(r, dict(clips), fed)
    eps = [torch.cat([eps_pool(r, k, dev)[s % r.mix["eps_pool"]] for k in range(r.world)]) for s in range(N_CHECKED)]
    with r.ref.precision(tf32):
        tr = r.ref.Trainer(tree, r.cfg, r.cfg["train"])
        ref_losses = []
        for s, (gt, _) in enumerate(fed):
            hr = torch.from_numpy(np.ascontiguousarray(gt)).to(dev).float() / 255.0
            loss, taken = tr.step(hr, eps[s])
            ref_losses.append(loss)
            if s == 0:
                g_ref = dict(zip(taken, _leaf_norms(list(taken.values()))))
        d_ref = dict(zip(tr.params, _leaf_norms([tr.params[n].detach() - tree[n] for n in tr.params])))
        d_prog = dict(zip(p3, _leaf_norms([p3[n] - tree[n] for n in p3])))
    med_g = float(np.median(list(g_ref.values())))
    moved = [n for n in g_ref if g_ref[n] >= MOVED * med_g]
    med_d = float(np.median([d_ref[n] for n in moved]))
    grad = {n: abs(g1[n] - g_ref[n]) / max(g_ref[n], med_g) for n in g_ref}
    change = {n: abs(d_prog[n] - d_ref[n]) / max(d_ref[n], med_d) for n in moved}

    def worst(gaps, ref):
        return [[n, gaps[n], ref[n], g_ref[n] / med_g] for n in sorted(gaps, key=gaps.get)[-3:]]

    r.info(losses=losses, ref_losses=ref_losses, leaves_moved=len(moved), leaves=len(g_ref),
           worst_grad_leaves=worst(grad, g_ref), worst_change_leaves=worst(change, d_ref),
           max_leaf_change_gap=max(change.values()))
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "grad_gap": max(grad.values()),
        "median_change_gap": float(np.median(list(change.values()))),
        "data_faults": float(data_faults),
    }


def _data_faults(r, clips, fed):
    """Rows of the compared batches that are not a crop of their named clip
    (any of the eight flips and turns, every frame in order), and rows equal
    to another: their count."""
    crop = r.cfg["datasets"]["train"]["GT_size"]
    faults, seen = 0, set()
    for gt, paths in fed:
        for row, path in zip(gt, paths):
            key = row.tobytes()
            faults += key in seen
            seen.add(key)
            faults += not _is_crop(clips[path.split("/")[0]], row, crop)
    return faults


def _is_crop(src, row, crop):
    """Whether ``row`` (T, crop, crop, 3) is a window of ``src`` (T, H, W, 3)
    seen through a flip of W, a flip of H and a transpose, in any
    combination: the windows whose first frame agrees at a few points are
    compared whole."""
    T, H, W, _ = src.shape
    ny, nx = H - crop + 1, W - crop + 1
    points = [(0, 0), (crop - 1, crop - 1), (0, crop - 1), (crop - 1, 0), (crop // 2, crop // 2),
              (crop // 3, 2 * crop // 3), (2 * crop // 3, crop // 5)]
    for hflip in (False, True):
        for vflip in (False, True):
            for rot in (False, True):
                win = row.transpose(0, 2, 1, 3) if rot else row
                win = win[:, ::-1] if vflip else win
                win = win[:, :, ::-1] if hflip else win
                hit = np.ones((ny, nx), bool)
                for a, b in points:
                    hit &= (src[0, a:a + ny, b:b + nx] == win[0, a, b]).all(-1)
                for y, x in zip(*np.nonzero(hit)):
                    if np.array_equal(src[:, y:y + crop, x:x + crop], win):
                        return True
    return False
