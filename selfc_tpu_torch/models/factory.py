"""Network factory: the full option dict (see selfc_tpu_torch/config.py for
the YAML-compatible schema) -> an initialized module on ``device``."""

from __future__ import annotations

import logging

from .inv_nets import SelfCNetCodec, SelfCNetGMM

logger = logging.getLogger("base")

_NOT_PORTED = {
    "IRN": "A22", "IRN_Contra_UP": "A22", "SelfC": "A22", "SelfC_shell": "A22",
}


def _clip_frames(opt):
    """The clip length the JAX package's model wrappers initialise the net
    with (``train/*_model.py:_init_params``): ``datasets.train.video_len``,
    else 3. The deformable aggregations' parameter shapes depend on it."""
    train_set = (opt.get("datasets") or {}).get("train") or {}
    return train_set.get("video_len") or 3


def define_G(opt, device=None, generator=None):
    """``device=None`` means the GPU (raises without one)."""
    net = opt["network_G"]
    model_type = opt["model"]
    which = net.get("which_model_G") or {}
    save_feats = (opt.get("train") or {}).get("save_chain_feats")
    # the opt-in chain schedules (ops/chain_variants.py; the JAX package's
    # SELFC_TPU_PALLAS_HG / _RIDE / _V3): an unknown name raises in the net
    variants = net.get("chain_variants") or ()
    # W-packing of narrow training latents (on unless false: the JAX
    # package's SELFC_TPU_PALLAS_PACK_W=0 turns it off)
    pack = net.get("pack_w")
    pack = True if pack is None else bool(pack)
    if model_type in ("SelfC_GMM", "SelfC_SR", "SelfC_Contra_UP"):
        nll_enabled = bool(net.get("nll_enabled"))
        lam_cond = (opt.get("train") or {}).get("lambda_cond_prob")
        if lam_cond and not nll_enabled:
            logger.warning(
                "train.lambda_cond_prob=%s is set but network_G.nll_enabled "
                "is false: the forward conditional NLL (loss_c) is hard-zero. "
                "Set network_G.nll_enabled: true to activate it.", lam_cond,
            )
        gm = net.get("global_module") or "nonlocal"
        return SelfCNetGMM(
            scale=net.get("scale") or opt["scale"],
            block_num=tuple(net.get("block_num") or (4, 4)),
            subnet_type=which.get("subnet_type", "D2DTNet"),
            init_mode=net.get("init") or "xavier",
            stp_blk_num=net.get("stp_blk_num") or 6,
            fh_loss=net.get("fh_loss") or "gmm",
            gmm_k=net.get("gmm_k") or 5,
            global_module=gm,
            nll_enabled=nll_enabled,
            save_chain_feats=True if save_feats is None else bool(save_feats),
            deform_radius=net.get("deform_radius"),
            frames=_clip_frames(opt),
            chain_variants=variants,
            pack_w=pack,
            device=device,
            generator=generator,
        )
    if model_type == "SelfC_GMM_Codec":
        # the de-artifact net is built from deart_net alone, as the JAX
        # package builds it (selfc_tpu/models/factory.py); h265_deart is read
        # by no module there. Without network_G.block_num the coupling has
        # (4, 4) blocks for every model type there, the codec's too
        return SelfCNetCodec(
            scale=net.get("scale") or opt["scale"],
            block_num=tuple(net.get("block_num") or (4, 4)),
            subnet_type=which.get("subnet_type", "D2DTNet"),
            init_mode=net.get("init") or "xavier",
            stp_blk_num=net.get("stp_blk_num") or 4,
            fh_loss=net.get("fh_loss") or "l2",
            gmm_k=net.get("gmm_k") or 5,
            global_module=net.get("global_module") or "nonlocal",
            stp_hidden_c=net.get("stp_hidden_c") or 24,
            stp_denseblock_innerc=net.get("stp_denseblock_innerc") or 12,
            deart_net=bool(net.get("deart_net")),
            deform_radius=net.get("deform_radius"),
            frames=_clip_frames(opt),
            save_chain_feats=True if save_feats is None else bool(save_feats),
            chain_variants=variants,
            pack_w=pack,
            device=device,
            generator=generator,
        )
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model type {model_type!r} is not ported yet "
            f"(ROADMAP {_NOT_PORTED[model_type]})"
        )
    raise NotImplementedError(f"model type {model_type!r} not supported")
