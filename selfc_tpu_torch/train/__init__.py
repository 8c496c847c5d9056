"""Model wrappers and their factory (reference codes/models/__init__.py:5-15)."""

from .rescale_model import RescaleModel  # noqa: F401


def create_model(opt, device=None, rng_seed: int = 0, mesh=None):
    """The wrapper of ``opt['model']``, as the JAX package's ``create_model``
    dispatches it. ``device=None`` means the GPU; ``mesh``
    (``parallel.mesh.make_mesh``) the devices it runs on (None: the
    wrapper's default over ``device``). ``mesh_sp`` > 1 (the image width
    split over a mesh row's cards) is ported for SelfC_GMM alone."""
    model = opt["model"]
    if (opt.get("mesh_sp") or 1) > 1 and model != "SelfC_GMM":
        raise NotImplementedError(
            f"mesh_sp > 1 for model {model!r}: the width split is ported for SelfC_GMM only; "
            "SelfC_GMM_Codec, the Haar nets (SelfC, SelfC_shell) and IRN wait on ROADMAP "
            "Queue A item 1 (the width split of the other nets)")
    if model in ("SelfC", "SelfC_VRN", "SelfC_GMM", "IRN"):
        return RescaleModel(opt, device=device, rng_seed=rng_seed, mesh=mesh)
    if model == "SelfC_GMM_Codec":
        from .codec_model import CodecModel

        return CodecModel(opt, device=device, rng_seed=rng_seed, mesh=mesh)
    raise NotImplementedError(f"Model [{model}] not recognized.")
