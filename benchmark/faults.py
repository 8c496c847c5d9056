"""The planted faults that the comparisons deciding ``correct`` are shown
to fail on. Each wraps the program and breaks one thing underneath the
driver: an answer altered where it is produced, a step that leaves the
state unchanged, half of the batch left out (the mean taken over the
rest), and across ranks the exchange of the gradients left out. A driver
names the ones its cell can have (``FAULTS``, on several ranks also
``RANK_FAULTS``); its ``Control`` is the other thing the comparisons fail
on: the plain reference put in the program's place one precision below."""

from __future__ import annotations

import numpy as np


class Fault:
    """The program with one fault planted: calls pass through, but for the
    one that the fault breaks."""

    def __init__(self, model):
        self.model = model

    def __getattr__(self, name):
        return getattr(self.model, name)


class AlteredAnswer(Fault):
    """One value of each answer altered where the program returns it: an SR
    pixel by 0.01, an LR pixel by one level, a bpp by a millionth, a loss by
    a ten-thousandth of itself."""

    def get_current_visuals(self):
        vis = dict(self.model.get_current_visuals())
        for key, by in (("SR", 1e-2), ("LR", 1 / 255)):
            a = np.array(vis[key], copy=True)
            a.reshape(-1)[a.size // 2] += by
            vis[key] = a
        return vis

    def get_current_metrics(self):
        met = dict(self.model.get_current_metrics())
        met["video_bpp"] += 1e-6
        return met

    def get_current_log(self):
        log = dict(self.model.get_current_log())
        log["loss"] *= 1.0 + 1e-4
        return log


class FrozenState(Fault):
    """A training step that leaves the parameters and the optimiser's state
    as they were."""

    def optimize_parameters(self, step, eps=None):
        self.model.optimizer.step = lambda *a, **k: None
        self.model.optimize_parameters(step, eps=eps)


class HalfBatch(Fault):
    """Half of the batch left out: the step takes the mean over the rest."""

    def feed_data(self, data):
        gt = data["GT"]
        return self.model.feed_data({**data, "GT": gt[: max(1, len(gt) // 2)]})

    def optimize_parameters(self, step, eps=None):
        return self.model.optimize_parameters(step, eps=None if eps is None else eps[: max(1, len(eps) // 2)])


class NoExchange(Fault):
    """The gradients' exchange between the ranks left out: each rank steps
    on its own batch's gradient."""

    def optimize_parameters(self, step, eps=None):
        import selfc_tpu_torch.train.rescale_model as rm

        saved, rm.all_reduce_grads = rm.all_reduce_grads, lambda params: None
        try:
            return self.model.optimize_parameters(step, eps=eps)
        finally:
            rm.all_reduce_grads = saved
