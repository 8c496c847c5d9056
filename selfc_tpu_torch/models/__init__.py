from .factory import define_G  # noqa: F401
