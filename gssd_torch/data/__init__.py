from gssd_torch.data.splitter import DataSplitter  # noqa: F401
from gssd_torch.data.dataset import LesionDataset  # noqa: F401
from gssd_torch.data.transforms import BaseTransform  # noqa: F401
from gssd_torch.data.synthetic import make_synthetic_dataset  # noqa: F401
from gssd_torch.data.dataset import (  # noqa: F401
    BatchLoader, MPBatchLoader, collate, collate_pixellink, collate_raw, device_prefetch,
    pad_targets, take_rows)
from gssd_torch.data.augment import SSDAugmentation  # noqa: F401
from gssd_torch.data.augment_device import DeviceAugmentation  # noqa: F401
from gssd_torch.data.device_cache import DeviceCacheLoader  # noqa: F401
