from .datasets import ArrayDataset, load_source  # noqa: F401
from .mixers import Mixture, build_mixture  # noqa: F401
from .pipeline import DeviceDataset, epoch_batch_indices, normalize_u8  # noqa: F401
