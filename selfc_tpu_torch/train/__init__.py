"""Model wrappers and their factory (reference codes/models/__init__.py:5-15)."""

from .rescale_model import RescaleModel  # noqa: F401


def create_model(opt, device=None, rng_seed: int = 0, mesh=None):
    """The wrapper of ``opt['model']``, as the JAX package's ``create_model``
    dispatches it (and SelfC_shell, the Haar net's other name, as SelfC).
    ``device=None`` means the GPU; ``mesh`` (``parallel.mesh.make_mesh``)
    the devices it runs on (None: the wrapper's default over ``device``).
    ``mesh_sp`` > 1 (the image width split over a mesh row's cards) is
    ported for SelfC_GMM, SelfC_GMM_Codec and the Haar nets; IRN has no
    wrapper to split (``RescaleModel`` raises for it)."""
    model = opt["model"]
    if model in ("SelfC", "SelfC_shell", "SelfC_VRN", "SelfC_GMM", "IRN"):
        return RescaleModel(opt, device=device, rng_seed=rng_seed, mesh=mesh)
    if model == "SelfC_GMM_Codec":
        from .codec_model import CodecModel

        return CodecModel(opt, device=device, rng_seed=rng_seed, mesh=mesh)
    raise NotImplementedError(f"Model [{model}] not recognized.")
