"""The port's training CLI, the counterpart of the root ``train.py``
(reference codes/train.py:93-346)::

    python -m selfc_tpu_torch.cli.train -opt <train yml> [--max-iters N] [--device cuda|cpu]

It writes ``experiments/<name>/`` under the working directory: the
``train_<name>`` / ``val_<name>`` logs, ``models/{iter}_G.msgpack`` at the
checkpoint cadence, ``latest_G.msgpack`` at the end and ``best_G.msgpack``
at a new best validation PSNR, and ``training_state/{iter}.state``.
``path.resume_state`` (a ``.state`` of this CLI or of the JAX package's)
resumes the epoch, the iteration, the weights
(``models/{iter}_G.msgpack``) and, unless ``train.resume_optimizer`` is
false, Adam's moments and step. SIGTERM / SIGINT checkpoint the current
iteration and stop; so does host memory above ``train.rss_limit_gb``
(default 100 GiB). The log lines are the root CLI's, character for
character; on the card each step line also carries ``gpu_step_s``, the mean
device time of a step over the print interval, as ``wall_s`` is the mean
wall time (CUDA events around ``feed_data`` + ``optimize_parameters``, read
only on the steps that print).

``--profile-at ITER [--profile-steps N] [--profile-dir DIR]`` (the JAX
package's ``SELFC_TPU_PROFILE_AT`` / ``_STEPS`` / ``_DIR``) traces N steps
(default 3) from iteration ITER with ``torch.profiler``: the device is
drained first, and the window closes after its last step with the device
synchronised, or on any way out of the loop (niter reached, a signal's
checkpoint, the memory guard, an exception). DIR (default
``experiments/<name>/profile``) gets ``trace.json`` and ``launches.json``
(the kernel wrappers' calls inside the window); ``python -m
selfc_tpu_torch.tools.profile_step DIR`` splits the trace by kernel.

Several processes: ``--launcher pytorch`` with the torch launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
see ``parallel/dist.py``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import math
import os
import random
import signal
import time

import numpy as np
import torch

from .. import config as option
from ..data import DistIterSampler, create_dataloader, create_dataset
from ..eval.rescaling import cal_metric
from ..parallel.dist import init_distributed
from ..parallel.mesh import model_mesh
from ..train import create_model
from ..train.checkpoint import load_training_state
from ..utils.logger import setup_logger
from ..utils.profile import StepTimer, launch_counts, trace

DATASET_RATIO = 200   # the reference's epoch inflation under a sampler (train.py:171-182)
EMA = 0.98            # of the data_s / step_s wall-time split


def _rss_gb() -> float:
    """Resident set size of this process in GiB (Linux)."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**30


def _malloc_trim() -> None:
    """Ask glibc to return freed heap to the OS (nothing where there is no glibc)."""
    import ctypes

    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:
        pass


def _flush(model) -> None:
    """Retire a pipelined codec step in flight, on every rank (its update
    may all-reduce) before rank 0 saves or evaluates."""
    flush = getattr(model, "flush_pipeline", None)
    if flush is not None:
        flush()


def log_line(epoch, step, logs, rate_source=None) -> str:
    """The root CLI's log line (train.py:279-314)."""
    msg = "<epoch:{:3d}, iter:{:8,d}, lr:{:.3e}> ".format(epoch, step, logs.get("lr", 0.0))
    for k, v in logs.items():
        if k in ("lr", "rate_source"):
            continue
        msg += "{:s}: {:.4e} ".format(k, v)
    # bpp provenance: any line printing a rate says where it came from
    if "img_bpp" in logs and rate_source:
        msg += "rate_src: {:s} ".format(rate_source)
    return msg


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a SelfC model with the PyTorch port.")
    parser.add_argument("-opt", type=str, required=True)
    parser.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                        help="several processes: the torch launcher's environment")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("--max-iters", type=int, default=None, help="override niter")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--profile-at", type=int, default=0,
                        help="trace the steps from this iteration with torch.profiler (0: none)")
    parser.add_argument("--profile-steps", type=int, default=3, help="steps in the traced window")
    parser.add_argument("--profile-dir", default=None,
                        help="where the trace goes (default: experiments/<name>/profile)")
    args = parser.parse_args(argv)
    opt = option.parse(args.opt, is_train=True)

    if args.launcher != "none":
        rank, world_size = init_distributed(args.device, sp=opt["mesh_sp"] or 1)
    else:
        rank, world_size = 0, 1
    opt["dist"] = world_size > 1
    opt["world_size"] = world_size

    if rank == 0:
        for key in ("experiments_root", "models", "training_state", "log", "val_images"):
            if opt["path"][key]:
                os.makedirs(opt["path"][key], exist_ok=True)
    setup_logger("base", opt["path"]["log"], "train_" + opt["name"], level=logging.INFO,
                 screen=rank == 0, tofile=rank == 0)
    setup_logger("val", opt["path"]["log"], "val_" + opt["name"], level=logging.INFO,
                 screen=rank == 0, tofile=rank == 0)
    logger = logging.getLogger("base")

    tb_logger = None
    if rank == 0 and opt["use_tb_logger"] and "debug" not in opt["name"]:
        try:
            from tensorboardX import SummaryWriter

            tb_logger = SummaryWriter(log_dir=os.path.join("tb_logger", opt["name"]))
        except ImportError:
            logger.warning("tensorboardX unavailable; skipping TB logging")

    seed = (opt["train"] or {}).get("manual_seed") or 10
    random.seed(seed)
    np.random.seed(seed)

    resume_state = None
    if opt["path"]["resume_state"]:
        resume_state = load_training_state(opt["path"]["resume_state"])
        option.check_resume(opt, resume_state["iter"])

    train_loader, val_loaders, total_iters = None, [], 0
    for phase, dataset_opt in (opt["datasets"] or {}).items():
        if phase == "train":
            train_set = create_dataset(dataset_opt)
            train_size = int(math.ceil(len(train_set) / (dataset_opt["batch_size"] or 1)))
            total_iters = args.max_iters or int(opt["train"]["niter"])
            sampler = None
            if opt["dist"]:
                sampler = DistIterSampler(len(train_set), world_size, rank, DATASET_RATIO)
            train_loader = create_dataloader(train_set, dataset_opt, opt, sampler)
            logger.info("Number of train images: {:,d}, iters: {:,d}".format(len(train_set), train_size))
        elif phase.startswith("val"):
            val_set = create_dataset(dataset_opt)
            val_loaders.append((dataset_opt["name"], create_dataloader(val_set, dataset_opt)))
    if train_loader is None:
        raise ValueError("no train dataset in config")

    # the process's cards, mesh_sp of them to a row (JAX train.py: make_mesh(sp=mesh_sp))
    mesh = model_mesh(args.device, opt["mesh_sp"] or 1)
    logger.info("mesh: %s", mesh)
    model = create_model(opt, device=args.device, rng_seed=seed, mesh=mesh)
    if resume_state is not None:
        # train.resume_optimizer: false mimics the reference, which restores no optimizer state
        restore_opt = (opt["train"] or {}).get("resume_optimizer")
        model.resume_training(opt["path"]["resume_state"],
                              restore_optimizer=restore_opt is None or bool(restore_opt))
        logger.info("Resuming training from epoch: %d, iter: %d.", resume_state["epoch"], resume_state["iter"])
    logger.info("Start training from epoch: %d, iter: %d", model.start_epoch, model.start_iter)

    stop_requested = {"flag": False}

    def _graceful(signum, frame):
        stop_requested["flag"] = True
        logger.warning("signal %d received; will checkpoint and stop.", signum)

    handlers = {}
    if rank == 0:
        handlers = {sig: signal.signal(sig, _graceful) for sig in (signal.SIGTERM, signal.SIGINT)}
    rss_limit = float((opt["train"] or {}).get("rss_limit_gb") or 100.0)
    prof_dir = args.profile_dir or os.path.join(opt["path"]["experiments_root"] or ".", "profile")
    prof = {"at": args.profile_at, "steps": max(1, args.profile_steps), "cm": None,
            "dir": prof_dir if rank == 0 else os.path.join(prof_dir, f"rank{rank}")}
    try:
        _train_epochs(opt, model, train_loader, val_loaders, logger, tb_logger, rank, total_iters,
                      stop_requested, rss_limit, prof)
    finally:
        # an unclosed trace is lost: close it on every way out of the loop
        if prof["cm"] is not None:
            _close_trace(prof, model, logger, "on loop exit", drain=False)
        for sig, h in handlers.items():
            signal.signal(sig, h)
        train_loader.close()
        for _, loader in val_loaders:
            loader.close()
    _flush(model)
    if rank == 0:
        logger.info("Saving the final model.")
        model.save("latest")
        logger.info("End of training.")


def _open_trace(prof, model, step, logger):
    """Drain the device (a pipelined codec step in flight, then the queue),
    then start the trace at iteration ``step``."""
    _flush(model)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    prof["first"], prof["counts"] = step, launch_counts()
    prof["cm"] = trace(prof["dir"], model.device)
    prof["cm"].__enter__()
    logger.info("profiler: trace started at iter %d -> %s", step, prof["dir"])


def _close_trace(prof, model, logger, why, last=None, drain=True):
    """Stop the trace (the device synchronised inside it) and write the
    wrappers' calls of its window beside it, ``launches.json``."""
    if drain:
        _flush(model)
    cm, prof["cm"] = prof["cm"], None
    cm.__exit__(None, None, None)
    now = launch_counts()
    window = {"first_iter": prof["first"], "last_iter": last, "device": str(model.device),
              "counts": {k: now[k] - prof["counts"][k] for k in now}}
    with open(os.path.join(prof["dir"], "launches.json"), "w") as f:
        json.dump(window, f)
    logger.info("profiler: trace closed %s", why)


def _train_epochs(opt, model, train_loader, val_loaders, logger, tb_logger, rank, total_iters,
                  stop_requested, rss_limit, prof):
    train_opt = opt["train"]
    print_freq = opt["logger"]["print_freq"] or 100
    ckpt_freq = int(opt["logger"]["save_checkpoint_freq"] or 2e4)
    val_freq = int(train_opt["val_freq"] or 1e4)
    current_step = model.start_iter
    best_psnr = -1.0
    # the wall-time split: the loader's wait against feed + step (EMA)
    ema_data = ema_step = 0.0
    n_timed = 0
    t_mark = time.perf_counter()
    last_print_t = None
    # the steps' device time (CUDA events, resolved at a print); none on the CPU
    gpu_timer = StepTimer(model.device) if model.device.type == "cuda" else None
    gpu_mark = (0, 0.0)   # (steps, seconds) the timer had at the last print
    # itertools.count: the loop ends at total_iters, not at an epoch
    # estimate, so a resume whose config changed the epoch math trains on
    for epoch in itertools.count(model.start_epoch):
        if opt["dist"] and train_loader.sampler is not None:
            train_loader.sampler.set_epoch(epoch)
        for train_data in train_loader:
            t_have_data = time.perf_counter()
            current_step += 1
            if current_step > total_iters:
                break
            if stop_requested["flag"]:
                logger.info("Checkpointing at iter %d before shutdown.", current_step)
                model.save(current_step)
                model.save_training_state(epoch, current_step)
                return
            if rank == 0 and current_step % 100 == 0 and _rss_gb() > rss_limit:
                _malloc_trim()
                rss = _rss_gb()
                if rss > rss_limit:
                    logger.warning("Host RSS %.1f GB > limit %.1f GB; checkpointing at iter %d and "
                                   "exiting for a clean relaunch.", rss, rss_limit, current_step)
                    model.save(current_step)
                    model.save_training_state(epoch, current_step)
                    return
            if prof["at"] and current_step == prof["at"]:
                _open_trace(prof, model, current_step, logger)
            if gpu_timer is not None:
                gpu_timer.tic()
            model.feed_data(train_data)
            model.optimize_parameters(current_step)
            if gpu_timer is not None:
                gpu_timer.toc()
            if prof["cm"] is not None and current_step >= prof["at"] + prof["steps"] - 1:
                _close_trace(prof, model, logger, f"at iter {current_step}", last=current_step)
            t_done = time.perf_counter()
            ema_data = EMA * ema_data + (1 - EMA) * (t_have_data - t_mark)
            ema_step = EMA * ema_step + (1 - EMA) * (t_done - t_have_data)
            t_mark = t_done
            n_timed += 1

            if current_step % print_freq == 0:
                logs = dict(model.get_current_log())
                logs["data_s"] = ema_data / (1 - EMA ** n_timed)
                logs["step_s"] = ema_step / (1 - EMA ** n_timed)
                if gpu_timer is not None:
                    gpu_timer.read()
                    n, total = gpu_timer.n - gpu_mark[0], gpu_timer.total - gpu_mark[1]
                    gpu_mark = (gpu_timer.n, gpu_timer.total)
                    logs["gpu_step_s"] = total / n
                # the mean wall time an iteration over the print interval
                now_wall = time.perf_counter()
                if last_print_t is not None:
                    logs["wall_s"] = (now_wall - last_print_t) / float(print_freq)
                last_print_t = now_wall
                # the host codec's whole wall time against the wait the
                # step paid: with train.codec_pipeline the difference is the overlap
                if getattr(model, "last_codec_total_seconds", 0.0) > 0.0:
                    logs["codec_tot_s"] = model.last_codec_total_seconds
                    logs["codec_wait_s"] = model.last_codec_host_seconds
                if tb_logger is not None:
                    for k, v in logs.items():
                        if k not in ("lr", "rate_source"):
                            tb_logger.add_scalar(k, v, current_step)
                logger.info(log_line(epoch, current_step, logs, getattr(model, "rate_source", None)))

            at_ckpt = current_step % ckpt_freq == 0
            at_val = bool(val_loaders) and current_step % val_freq == 0
            if at_ckpt or at_val:
                _flush(model)
            if rank == 0 and at_ckpt:
                logger.info("Saving models and training states.")
                model.save(current_step)
                model.save_training_state(epoch, current_step)
            if rank == 0 and at_val:
                psnrs = []
                for name, loader in val_loaders:
                    vdir = os.path.join(opt["path"]["val_images"], name)
                    p, s, _, _ = cal_metric(loader, model, vdir, save_images=False)
                    logging.getLogger("val").info(
                        "# Validation {} # PSNR: {:.6f} SSIM: {:.6f}".format(name, p, s))
                    psnrs.append(p)
                avg = sum(psnrs) / max(1, len(psnrs))
                if tb_logger is not None:
                    tb_logger.add_scalar("val_psnr", avg, current_step)
                if avg > best_psnr:
                    best_psnr = avg
                    logger.info("New best PSNR %.4f; saving 'best'.", avg)
                    model.save("best")
        if current_step > total_iters:
            break


if __name__ == "__main__":
    main()
