"""Rescaling model wrapper — the JAX package's ``RescaleModel`` for the
SelfC_GMM and SelfC (Haar) model types: feed_data / optimize_parameters /
test / downscale / upscale / get_current_log / get_current_visuals / load /
save / save_training_state / resume_training. The IRN model type has no
wrapper (the JAX ``RescaleModel`` cannot build it: ``InvRescaleNet`` has no
``roundtrip``); ``define_G`` builds its net. ``train.gan_weight`` adds the
adversarial branch (``train/gan.py``): D and its optimizer, saved as
``{iter}_D`` beside G and in the ``.state``'s ``extra``.

A training step runs under cuDNN's deterministic algorithms
(``step_algorithms``), so that it repeats bit for bit as the JAX step does;
the flags are set for the step alone.

The model runs on a ``(dp, sp)`` mesh (``parallel/mesh.py``; by default
the process's cards, ``mesh_sp`` of them to a row). ``test()`` splits its
calls' GOP groups over the dp rows, and the single-group path's width over
a row's sp cards. The training step runs on the mesh's first row (dp
across processes is ``parallel/dist.py``'s gradient all-reduce): on its
one card, or with ``mesh_sp`` > 1 (SelfC_GMM and the Haar SelfC net, with
every option) the width split over its cards (``parallel/spatial.py``), the
losses means over the whole width and the gradients summed into the master
parameters on the first card, where the clip and Adam run once. The
adversarial step's G side
takes its pixel losses from the same split; D and F run on the master card
on the whole frames (the fake's shards gathered there), as D's step does.

All host I/O is channels-last numpy ``(B, T, H, W, 3)``.
"""

from __future__ import annotations

import contextlib
import copy
import logging
from collections import OrderedDict

import numpy as np
import torch

from .. import resolve_device
from ..models import define_G
from ..ops.quantize import quantize_ste
from ..ops.resize import area_down, gaussian_downsample, imresize_matlab
from ..parallel.dist import all_reduce_grads, finite_everywhere, frames_to_device
from ..parallel.mesh import Replicas, dp_gather, dp_split, gather_w, model_mesh, shard_w
from ..parallel.spatial import check_supported, check_width, degrade_shards, splitter, sum_to
from ..utils.jax_import import export_jax_params, load_jax_params, stack_scan_chain
from . import checkpoint as ckpt
from .losses import reconstruction_error, reconstruction_loss
from .lr_schedule import cosine_restart, multistep_restart

logger = logging.getLogger("base")


def make_degrade(distortion: str, scale: int):
    """The function that makes the LR target from the HR clip."""
    if distortion == "pytorch_bicubic":
        return lambda x: area_down(x, scale)
    if distortion == "sr_bd":
        return lambda x: gaussian_downsample(x, scale)
    if distortion == "matlab":
        return lambda x: imresize_matlab(x, 1.0 / scale)
    raise ValueError(f"distortion {distortion!r}")


def clip_by_global_norm_(params, max_norm: float):
    """Scale the gradients in place so that their global l2 norm is at most
    ``max_norm`` (exactly ``g * max_norm / norm`` when it is larger, else
    untouched; no epsilon in the divisor). Stays on the device: no
    synchronisation. Returns the norm before clipping.

    On the CPU each leaf's norm is accumulated in float64: torch sums an
    fp32 norm there in fp32, element after element, and the codec's
    gradient norm (its surrogate's leaves reach 9.3 M elements) came out
    8.6e-5 low, every clipped leaf as far off the JAX package's
    (``tests/codec_step_precision.py``). On the card torch reduces in a
    tree, in the gradients' type."""
    grads = [p.grad for p in params if p.grad is not None]
    if grads and grads[0].device.type == "cpu":
        norms = [n.to(grads[0].dtype) for n in torch._foreach_norm(grads, 2, dtype=torch.float64)]
    else:
        norms = torch._foreach_norm(grads)
    norm = torch.linalg.vector_norm(torch.stack(norms))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


@contextlib.contextmanager
def step_algorithms(deterministic: bool = True):
    """The cuDNN flags of a training step: with ``deterministic``, cuDNN's
    deterministic convolution algorithms and no autotuning; the two flags
    are restored when the step ends, and no other flag is touched."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    if deterministic:
        cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def build_adam(params, to):
    """Adam with the weight decay coupled into the gradient (``g + wd * p``
    before the moments), eps 1e-8 outside the root, from the ``train``
    options; the caller clips the gradients by global norm first
    (``clip_by_global_norm_``). Returns the optimizer and the steps at which
    its moments are cleared (``train.restarts`` when ``train.clear_state``
    is set)."""
    optimizer = torch.optim.Adam(
        params, lr=to.get("lr_G") or 1e-4,
        betas=(to.get("beta1") or 0.9, to.get("beta2") or 0.999),
        eps=1e-8, weight_decay=to.get("weight_decay_G") or 0.0)
    clear = (frozenset(int(r) for r in (to.get("restarts") or []))
             if to.get("clear_state") else frozenset())
    return optimizer, clear


class RescaleModel:
    """Training and eval wrapper for the SelfC_GMM and SelfC model types."""

    def __init__(self, opt, device=None, rng_seed: int = 0, mesh=None):
        """``device=None`` means the GPU (raises without one). ``mesh``
        (``parallel.mesh.make_mesh``): the devices the model runs on, the
        masters on its first; None builds ``model_mesh(device,
        opt['mesh_sp'])``: the process's cards, or the one device named.
        ``val.sample_seed`` overrides ``rng_seed``: it seeds both the
        parameter initialisation and the generator the GMM prior draws its
        noise from. With ``opt['is_train']`` the optimizer is built from
        ``opt['train']``, and with ``train.gan_weight`` the adversarial
        branch. ``path.pretrain_model_G`` (a msgpack checkpoint or a
        reference ``.pth``) and ``path.pretrain_model_D`` are loaded last
        (``load``). ``cudnn_deterministic`` (True) is the step's choice of
        cuDNN algorithms (``step_algorithms``); a timing may set it False."""
        if opt["model"] in ("IRN", "IRN_Contra_UP"):
            raise NotImplementedError(
                f"model {opt['model']!r}: the JAX package's RescaleModel cannot build it either "
                "(it initialises through net.roundtrip, which InvRescaleNet lacks); build the net "
                "with selfc_tpu_torch.models.define_G")
        cfg_seed = (opt.get("val") or {}).get("sample_seed")
        if cfg_seed is not None:
            rng_seed = int(cfg_seed)
        self.opt = opt
        self.is_train = bool(opt.get("is_train"))
        self.train_opt = opt.get("train") or {}
        self.mesh = mesh if mesh is not None else model_mesh(resolve_device(device), opt.get("mesh_sp") or 1)
        self.device = self.mesh.master
        self.scale = opt["scale"]
        self.distortion = opt.get("distortion") or "sr_bd"
        self.degrade = make_degrade(self.distortion, self.scale)
        init_gen = torch.Generator().manual_seed(rng_seed)
        self.net = define_G(opt, device=self.device, generator=init_gen)
        if self.mesh.sp > 1:
            check_supported(self.net)
            logger.info("mesh_sp %d: %s's width split over %s (parallel/spatial.py)", self.mesh.sp,
                        type(self.net).__name__, [str(d) for d in self.mesh.devices[0]])
        self.net.eval()
        self._net_cast = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self._arch = {"SelfC_GMM": "gmm", "SelfC_GMM_Codec": "codec", "SelfC": "haar",
                      "SelfC_shell": "haar", "IRN": "irn"}.get(opt["model"], "gmm")
        self.log_dict = OrderedDict()
        self._raw_logs = None
        self.start_iter = self.start_epoch = 0
        self.cudnn_deterministic = True
        self.gan = None
        if self.is_train:
            self._build_optimizer()
            if self.train_opt.get("gan_weight"):
                if self.train_opt.get("fused_optimizer"):
                    raise ValueError("train.fused_optimizer is not supported with the GAN branch (as in the "
                                     "JAX package); unset one of the two")
                from .gan import AdversarialBranch

                self.gan = AdversarialBranch(self, generator=torch.Generator().manual_seed(rng_seed + 1))
        self.load()

    def _build_optimizer(self):
        """``train.fused_optimizer`` is accepted and changes nothing: it
        names the same arithmetic on one flat vector, and there is one
        optimizer here."""
        to = self.train_opt
        base_lr = to.get("lr_G") or 1e-4
        self.optimizer, self._clear_state_steps = build_adam(self.net.parameters(), to)
        scheme = to.get("lr_scheme") or "MultiStepLR"
        if scheme == "MultiStepLR":
            self.lr_fn = multistep_restart(
                base_lr, to.get("lr_steps") or [], to.get("lr_gamma") or 0.5,
                to.get("restarts"), to.get("restart_weights"),
                to.get("warmup_iter") or -1)
        elif scheme == "CosineAnnealingLR_Restart":
            self.lr_fn = cosine_restart(
                base_lr, to.get("T_period"), to.get("eta_min") or 1e-7,
                to.get("restarts"), to.get("restart_weights"),
                to.get("warmup_iter") or -1)
        else:
            raise NotImplementedError(scheme)

    # ------------------------------------------------------------------
    def load_jax_params(self, tree):
        """Parameters in the JAX package's tree (numpy leaves) -> the net."""
        load_jax_params(self.net, tree)
        self._net_cast = None

    def load(self):
        """Load ``path.pretrain_model_G`` into the net and, with the
        adversarial branch, ``path.pretrain_model_D`` into D, if set."""
        path_opt = self.opt.get("path") or {}
        path = path_opt.get("pretrain_model_G")
        if path:
            logger.info("Loading model for G [%s] ...", path)
            block_num = tuple(self.opt["network_G"].get("block_num") or (4, 4))
            self.load_jax_params(ckpt.load_network(path, export_jax_params(self.net),
                                                   self._arch, block_num))
        d_path = path_opt.get("pretrain_model_D")
        if d_path and self.gan is not None:
            logger.info("Loading model for D [%s] ...", d_path)
            load_jax_params(self.gan.netD, ckpt.load_network(d_path, export_jax_params(self.gan.netD)))

    def save(self, iter_label):
        """``{iter}_G.msgpack`` (stacked as the JAX package's ``scan_blocks``
        net keeps it when the net has that flag), and ``{iter}_D`` with the
        adversarial branch."""
        tree = export_jax_params(self.net)
        if getattr(self.net, "scan_blocks", False):
            tree = stack_scan_chain(tree, self.net.n_blocks)
        path = ckpt.save_network(tree, self.opt["path"]["models"], iter_label)
        if self.gan is not None:
            ckpt.save_network(export_jax_params(self.gan.netD), self.opt["path"]["models"], iter_label, "D")
        return path

    def save_training_state(self, epoch, it):
        """``{it}.state``: G's optimizer state as the JAX package's optax
        chain keeps it (the clip's and the weight decay's empty states, then
        Adam's, the moments nested as the JAX tree); with the adversarial
        branch its ``extra`` holds D's, the same way, and D's running
        statistics."""
        to = self.train_opt
        stack = None
        if getattr(self.net, "scan_blocks", False):
            stack = lambda tree: stack_scan_chain(tree, self.net.n_blocks)  # noqa: E731
        g_state = ckpt.optax_adam_state(self.optimizer, self.net.named_parameters(), to.get("gradient_clipping"),
                                        to.get("weight_decay_G"), stack)
        extra = None
        if self.gan is not None:
            extra = {"d_opt_state": ckpt.optax_adam_state(self.gan.optimizer, self.gan.netD.named_parameters(),
                                                          to.get("gradient_clipping")),
                     "d_stats": self.gan.stats_numpy()}
        return ckpt.save_training_state(self.opt["path"]["training_state"], epoch, it, g_state, extra=extra)

    def resume_training(self, state_path: str, restore_optimizer: bool = True):
        """Epoch and iteration from a ``.state`` file (the JAX package's or
        the port's), and with ``restore_optimizer`` Adam's moments and step.
        The reference restores no optimizer state: pass False to match it."""
        payload = ckpt.load_training_state(state_path)
        self.start_epoch = payload["epoch"]
        self.start_iter = payload["iter"]
        if restore_optimizer and self.is_train:
            ckpt.restore_adam(self.optimizer, self.net.named_parameters(), payload["opt_state"])
            extra = payload.get("extra") or {}
            if self.gan is not None and "d_opt_state" in extra:
                ckpt.restore_adam(self.gan.optimizer, self.gan.netD.named_parameters(), extra["d_opt_state"])
                self.gan.load_stats(extra["d_stats"])
        return payload

    def _eval_dtype(self):
        """val.eval_dtype: bfloat16 switches the eval roundtrip to bf16
        activations and parameters; outputs return as fp32 so the STE
        quantization and the metrics are unaffected. Default fp32."""
        name = str((self.opt.get("val") or {}).get("eval_dtype") or "float32").lower()
        if name in ("bf16", "bfloat16"):
            return torch.bfloat16
        if name in ("f32", "fp32", "float32"):
            return None
        raise ValueError(f"val.eval_dtype {name!r}")

    def _net_for(self, dt):
        if dt is None:
            return self.net
        if self._net_cast is None:
            self._net_cast = copy.deepcopy(self.net).to(dt)
        return self._net_cast

    @torch.no_grad()
    def _encode(self, x):
        dt = self._eval_dtype()
        y, _ = self._net_for(dt).encode(x if dt is None else x.to(dt))
        return y.float()

    @torch.no_grad()
    def _decode(self, lr, eps):
        dt = self._eval_dtype()
        hr, hf = self._net_for(dt).decode(lr if dt is None else lr.to(dt), eps=eps)
        return hr.float(), hf.float()

    def _draw_eps(self, lr_shape):
        return torch.randn(self.net.eps_shape(lr_shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)

    # ------------------------------------------------------------------
    def feed_data(self, data):
        """data['GT']: numpy (B, T, H, W, 3) RGB in [0,1] (or uint8). A
        clip shorter than ``datasets.train.video_len`` is padded to it with
        repeats of its last frame. Returns the clip's own length. With
        ``mesh_sp`` > 1, W must split into sp shards of whole LR columns no
        narrower than a block's halo (``spatial.width_rule``: 4 LR columns
        for D2DT chains at every level; 20, on a 4-column grid, for the Haar
        prior's FeatureCollapse blocks; 80, on an 8-column grid, for
        HighOrderTNet subnets): the JAX package's test keeps W a multiple of
        sp * scale * 4, which implies the first; 144 at sp 2 (18 LR columns a
        shard) passes too."""
        gt = np.asarray(data["GT"])
        clip_length = gt.shape[1]
        check_width(gt.shape[3], self.mesh.sp, self.net)
        t_cfg = ((self.opt.get("datasets") or {}).get("train") or {}).get("video_len")
        if t_cfg and clip_length < t_cfg:
            pad = np.repeat(gt[:, -1:], t_cfg - clip_length, axis=1)
            gt = np.concatenate([gt, pad], axis=1)
        self.real_H = frames_to_device(gt, self.device)
        return clip_length

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _pixel_losses(self, hr, ref_l, eps):
        """The roundtrip and its losses: ``(loss, logs, out)``. With
        ``train.mixed_precision`` the activations are bf16 and the
        parameters stay fp32 masters (each op casts its weights down); the
        losses are taken in fp32 and the 255-level quantization always
        rounds in fp32."""
        x_in = hr.to(torch.bfloat16) if self.train_opt.get("mixed_precision") else hr
        out = self.net.roundtrip(x_in, eps=eps)
        crit_f, crit_b = self._criteria()
        loss, logs = self._weighted_losses(reconstruction_loss(out["lr_pre_quant"].float(), ref_l, crit_f),
                                           reconstruction_loss(out["hr"].float(), hr, crit_b),
                                           out["loss_c"].float())
        return loss, logs, out

    def _criteria(self):
        """The pixel criteria of the LR fit and the HR reconstruction."""
        to = self.train_opt
        return to.get("pixel_criterion_forw") or "l2", to.get("pixel_criterion_back") or "l1"

    def _weighted_losses(self, forw, back, nll):
        """``(loss, logs)`` from the means of the LR fit, the HR
        reconstruction and the prior's NLL: each weighted by its lambda."""
        to = self.train_opt
        l_forw_fit = (to.get("lambda_fit_forw") or 1.0) * forw
        l_back_rec = (to.get("lambda_rec_back") or 1.0) * back
        loss_c = (to.get("lambda_cond_prob") or 0.0) * nll
        # the total is scaled by the 144*144*3 values of a training crop
        loss = (l_forw_fit + l_back_rec + loss_c) * 144 * 144 * 3
        return loss, {"l_forw_fit": l_forw_fit, "l_back_rec": l_back_rec, "loss_c": loss_c, "loss": loss}

    def optimize_parameters(self, step: int, eps=None, gp_eps=None):
        """One training step on the clip of ``feed_data``. ``eps`` is the
        prior's standard-normal noise (see ``SelfCNetGMM.eps_shape``); by
        default it is drawn from the model's generator. A non-finite loss
        skips the whole update, parameters and moments
        (``skipped_nonfinite`` in the log); reading that decision is the
        step's one synchronisation with the device. With more than one
        process (``parallel/dist.py``) the gradients are averaged over them
        before the clip, and a loss that is not finite on any rank skips
        the update on all. With the adversarial branch the step is
        ``AdversarialBranch.train_step`` (``gp_eps``: wgan-gp's
        interpolation weights, ``(B*T, 1, 1, 1)``, drawn when None)."""
        if not self.is_train:
            raise RuntimeError("optimize_parameters needs opt['is_train']")
        with step_algorithms(self.cudnn_deterministic):
            self._optimize(step, eps, gp_eps)

    def _optimize(self, step, eps, gp_eps):
        lr_value = self.lr_fn(step)
        hr = self.real_H
        if eps is None:
            B, T, H, W, _ = hr.shape
            eps = self._draw_eps((B, T, H // self.scale, W // self.scale, 3))
        else:
            eps = torch.as_tensor(eps, dtype=torch.float32, device=self.device)
        if self.gan is not None:
            # the JAX package's combined step clears no moments at a restart
            self._raw_logs = self.gan.train_step(self, step, lr_value, self.gan.lr_d_fn(step), eps, gp_eps)
            self._raw_logs_lr = lr_value
            return
        if step in self._clear_state_steps:
            self.optimizer.state.clear()
        self.optimizer.zero_grad(set_to_none=True)
        if self.mesh.sp == 1:
            with torch.no_grad():
                ref_l = self.degrade(hr)
            loss, logs, _ = self._pixel_losses(hr, ref_l, eps)
        else:
            loss, logs, _ = self._width_split_losses(hr, eps)
        ok = finite_everywhere(loss)
        if ok:
            loss.backward()
            all_reduce_grads(self.net.parameters())
            clip = self.train_opt.get("gradient_clipping")
            if clip:
                self.grad_norm = clip_by_global_norm_(list(self.net.parameters()), float(clip))
            for group in self.optimizer.param_groups:
                group["lr"] = lr_value
            self.optimizer.step()
            self._net_cast = None
        logs = {k: v.detach() for k, v in logs.items()}
        logs["skipped_nonfinite"] = torch.full_like(logs["loss"], 0.0 if ok else 1.0)
        self._raw_logs, self._raw_logs_lr = logs, lr_value

    def _width_split_losses(self, hr, eps):
        """``_pixel_losses`` with the width split over the mesh's first row:
        each term a sum over the shards divided by the whole batch's count;
        ``out`` holds the roundtrip's shards."""
        crit_f, crit_b = self._criteria()
        row = self.mesh.devices[0]
        xs, es = shard_w(hr, row), shard_w(eps, row, axis=3)
        with torch.no_grad():
            refs = degrade_shards(self.distortion, xs, self.scale, self.degrade)
        x_in = [x.to(torch.bfloat16) for x in xs] if self.train_opt.get("mixed_precision") else xs
        out = splitter(self.net, Replicas(), self.device).roundtrip(x_in, es)
        n_hr = hr.numel()
        n_lr = n_hr // self.scale ** 2
        forw = sum_to([reconstruction_error(t.float(), r, crit_f) for t, r in zip(out["lr_pre_quant"], refs)],
                      self.device) / n_lr
        back = sum_to([reconstruction_error(t.float(), x, crit_b) for t, x in zip(out["hr"], xs)],
                      self.device) / n_hr
        nll = (out["loss_c"].float() / (n_lr // 3 * self.net.hf_dim) if out["loss_c"] is not None
               else torch.zeros((), device=self.device))
        return (*self._weighted_losses(forw, back, nll), out)

    def get_current_log(self):
        """The last step's losses as floats (one read from the device, made
        here and not in the step), with ``skipped_nonfinite`` and ``lr``."""
        if self._raw_logs is not None:
            keys = sorted(self._raw_logs)
            vals = torch.stack([self._raw_logs[k].float() for k in keys]).tolist()
            self.log_dict = OrderedDict(zip(keys, vals))
            self.log_dict["lr"] = float(self._raw_logs_lr)
            self._raw_logs = None
        return self.log_dict

    def test(self, gop: int = 7):
        """GOP-chunked eval roundtrip: encode -> split -> quantize ->
        decode per ``gop``-frame group, the last group padded by repeating
        the final frame.

        ``val.gop_batch: N`` folds N independent GOPs into the batch axis
        of ONE encode + ONE decode call (unset: up to 4; 1 = sequential
        calls). The trailing call is padded with repeats of its last GOP.
        One ``eps`` is drawn per real group from the model's generator on
        the master card, in the order of the sequential path, so the sample
        stream depends neither on ``gop_batch`` nor on the mesh.

        On the mesh, as the JAX package places them: a batched call's GOP
        groups split over the dp rows (each row's first card runs its share
        with its copy of the parameters, taken at this call); a one-group
        call splits its clips over the rows where they divide, and its width
        over each row's sp cards. The quantised LR is one tensor on the
        master card, gathered before it is split again for the decode."""
        x = self.real_H
        B, T = x.shape[:2]
        n_groups = -(-T // gop)
        n_batch = (self.opt.get("val") or {}).get("gop_batch")
        if n_batch is None:
            n_batch = max(1, min(4, n_groups))
        n_batch = int(n_batch)

        groups = []
        for start in range(0, T, gop):
            idx = list(range(start, min(start + gop, T)))
            orig = len(idx)
            idx += [T - 1] * (gop - orig)
            groups.append((torch.as_tensor(idx, device=self.device), orig))

        reps = Replicas(self._eval_dtype())
        fake_H, forw_L, forw_Hf, sample_H = [], [], [], []
        for i in range(0, len(groups), n_batch):
            grp = groups[i:i + n_batch]
            pad_grp = grp + [grp[-1]] * (n_batch - len(grp))
            chunk = torch.cat([x[:, g[0]] for g in pad_grp], dim=0)
            rows = self._eval_rows(chunk.shape[0], whole_rows=len(pad_grp) == 1)
            y = self._encode_on(rows, reps, chunk)
            lr = quantize_ste(y[..., :3].contiguous())
            eps = [self._draw_eps((B,) + tuple(lr.shape[1:])) for _ in grp]
            eps += [eps[-1]] * (n_batch - len(grp))
            hr, hf = self._decode_on(rows, reps, lr, torch.cat(eps, dim=0))
            for j, (_, orig) in enumerate(grp):
                sl = slice(j * B, (j + 1) * B)
                fake_H.append(hr[sl, :orig])
                forw_L.append(lr[sl, :orig])
                forw_Hf.append(y[sl, :orig, ..., 3:])
                sample_H.append(hf[sl, :orig])
        self.fake_H = torch.cat(fake_H, dim=1).cpu().numpy()
        self.forw_L = torch.cat(forw_L, dim=1).cpu().numpy()
        self.forw_H = torch.cat(forw_Hf, dim=1).cpu().numpy()
        self.sample_H = torch.cat(sample_H, dim=1).cpu().numpy()

    def _eval_rows(self, n: int, whole_rows: bool):
        """The devices an eval call of ``n`` clips runs on, a list of rows:
        with ``whole_rows`` the mesh's rows (all where n divides, else the
        first), each with its sp cards; else every row's first card."""
        if whole_rows:
            return self.mesh.devices if n % self.mesh.dp == 0 else self.mesh.devices[:1]
        return [row[:1] for row in self.mesh.devices]

    def _encode_on(self, rows, reps, x):
        """``_encode`` of the clips ``x`` on ``rows`` (``_eval_rows``),
        gathered on the master card."""
        if len(rows) == 1 and len(rows[0]) == 1 and rows[0][0] == self.device:
            return self._encode(x)
        dt = self._eval_dtype() or torch.float32
        outs = []
        with torch.no_grad():
            for row, part in zip(rows, dp_split(x, [row[0] for row in rows])):
                if len(row) > 1:
                    ys, _ = splitter(self.net, reps, self.device).encode(
                        [s.to(dt) for s in shard_w(part, row)])
                    outs.append(gather_w(ys, self.device))
                else:
                    outs.append(reps.apply(row[0], self.net, lambda m, t: m.encode(t)[0], part.to(dt)))
        return dp_gather(outs, x.shape[0], self.device).float()

    def _decode_on(self, rows, reps, lr, eps):
        """``_decode`` of ``lr`` with the noise ``eps`` on ``rows``, gathered
        on the master card."""
        if len(rows) == 1 and len(rows[0]) == 1 and rows[0][0] == self.device:
            return self._decode(lr, eps)
        dt = self._eval_dtype() or torch.float32
        hrs, hfs = [], []
        with torch.no_grad():
            for row, lr_r, eps_r in zip(rows, dp_split(lr, [r[0] for r in rows]),
                                        dp_split(eps, [r[0] for r in rows])):
                if len(row) > 1:
                    hr, hf = splitter(self.net, reps, self.device).decode(
                        [s.to(dt) for s in shard_w(lr_r, row)], shard_w(eps_r, row, axis=3))
                    hr, hf = gather_w(hr, self.device), gather_w(hf, self.device)
                else:
                    hr, hf = reps.apply(row[0], self.net, lambda m, t, e: m.decode(t, eps=e), lr_r.to(dt), eps_r)
                hrs.append(hr)
                hfs.append(hf)
        n = lr.shape[0]
        return dp_gather(hrs, n, self.device).float(), dp_gather(hfs, n, self.device).float()

    def downscale(self, hr):
        x = torch.as_tensor(np.asarray(hr), dtype=torch.float32, device=self.device)
        y = self._encode(x)
        return quantize_ste(y[..., :3].contiguous()).cpu().numpy()

    def upscale(self, lr):
        x = torch.as_tensor(np.asarray(lr), dtype=torch.float32, device=self.device)
        hr, _ = self._decode(x, self._draw_eps(x.shape))
        return hr.cpu().numpy()

    def get_current_visuals(self):
        out = OrderedDict()
        out["SR"] = self.fake_H
        out["LR"] = self.forw_L
        with torch.no_grad():
            out["LR_ref"] = self.degrade(self.real_H).cpu().numpy()
        out["GT"] = self.real_H.cpu().numpy()
        out["forw_H"] = self.forw_H
        return out
