from .loader import create_dataloader, create_dataset  # noqa: F401
from .sampler import DistIterSampler  # noqa: F401
