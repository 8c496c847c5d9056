"""Model wrappers and their factory (reference codes/models/__init__.py:5-15)."""

from .rescale_model import RescaleModel  # noqa: F401


def create_model(opt, device=None, rng_seed: int = 0):
    """The wrapper of ``opt['model']``, as the JAX package's ``create_model``
    dispatches it. ``device=None`` means the GPU."""
    if (opt.get("mesh_sp") or 1) > 1:
        raise NotImplementedError(
            "mesh_sp > 1 splits the image width over several chips; it does not apply to "
            "the port on one card")
    model = opt["model"]
    if model in ("SelfC", "SelfC_VRN", "SelfC_GMM", "IRN"):
        return RescaleModel(opt, device=device, rng_seed=rng_seed)
    if model == "SelfC_GMM_Codec":
        from .codec_model import CodecModel

        return CodecModel(opt, device=device, rng_seed=rng_seed)
    raise NotImplementedError(f"Model [{model}] not recognized.")
