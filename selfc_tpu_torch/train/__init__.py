from .rescale_model import RescaleModel  # noqa: F401
