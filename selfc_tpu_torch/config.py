"""YAML option parsing, the same schema as the JAX package's config.

* ``NoneDict``: missing keys read as None so sparse configs default
  features off.
* Keys of the port alone, where the JAX package reads an environment
  variable: ``network_G.chain_variants`` (``SELFC_TPU_PALLAS_HG/_RIDE/_V3``)
  and ``network_G.pack_w`` (W-packing of narrow latents, on unless false;
  ``SELFC_TPU_PALLAS_PACK_W=0``); ``models/factory.py`` reads them.
* ``parse(path, is_train)``: loads YAML, injects per-dataset scale/phase,
  expands experiment/result paths (``path.experiments_root``, ``models``,
  ``training_state``, ``log``, ``val_images`` under ``experiments/<name>``
  of the working directory when training, ``results_root`` and ``log``
  under ``results/<name>`` when not), applies debug-mode frequency
  overrides. ``gpu_ids`` is accepted and ignored.
* ``check_resume(opt, iter)``: points ``path.pretrain_model_G`` at the
  resumed iteration's checkpoint.

PyYAML is imported inside ``parse`` only: a caller that builds its option
dict in Python (``dict_to_nonedict``) does not need it.
"""

from __future__ import annotations

import os
import os.path as osp


class NoneDict(dict):
    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict({k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def parse(opt_path: str, is_train: bool = True):
    import yaml

    with open(opt_path, "r") as f:
        opt = yaml.safe_load(f)

    opt["is_train"] = is_train
    scale = opt.get("scale")

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        dataset["scale"] = scale
        if dataset.get("dataroot_GT") is not None:
            dataset["dataroot_GT"] = osp.expanduser(dataset["dataroot_GT"])
        if dataset.get("dataroot_LQ") is not None:
            dataset["dataroot_LQ"] = osp.expanduser(dataset["dataroot_LQ"])
        dataset["data_type"] = (
            "lmdb"
            if dataset.get("dataroot_GT", "") and str(dataset.get("dataroot_GT")).endswith("lmdb")
            else "img"
        )

    # path expansion
    opt.setdefault("path", {})
    for key, p in list(opt["path"].items()):
        if p and ("resume" in key or "pretrain" in key or "strict" in key):
            opt["path"][key] = osp.expanduser(p) if isinstance(p, str) else p
    opt["path"]["root"] = os.getcwd()
    if is_train:
        experiments_root = osp.join(opt["path"]["root"], "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_state"] = osp.join(experiments_root, "training_state")
        opt["path"]["log"] = experiments_root
        opt["path"]["val_images"] = osp.join(experiments_root, "val_images")
        if "debug" in opt["name"]:
            opt["train"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(opt["path"]["root"], "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root

    return dict_to_nonedict(opt)


def check_resume(opt, resume_iter):
    """Re-point ``path.pretrain_model_G`` at the resume checkpoint,
    ``{path.models}/{resume_iter}_G.msgpack`` (reference options.py:105-119),
    and with the adversarial branch (``train.gan_weight``)
    ``path.pretrain_model_D`` at ``{resume_iter}_D.msgpack``, as the
    reference does for its GAN models (the JAX package re-points G alone, so
    its resumed D starts from a fresh init)."""
    if opt["path"]["resume_state"]:
        opt["path"]["pretrain_model_G"] = osp.join(opt["path"]["models"], f"{resume_iter}_G.msgpack")
        if (opt.get("train") or {}).get("gan_weight"):
            opt["path"]["pretrain_model_D"] = osp.join(opt["path"]["models"], f"{resume_iter}_D.msgpack")
