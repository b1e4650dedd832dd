from objectdetection_3d_tpu_torch.dataset.base import (  # noqa: F401
    BaseDataset,
    BaseDatasetSplit,
)
from objectdetection_3d_tpu_torch.dataset.forest import (  # noqa: F401
    Forest3D,
    ForestSplit,
)
from objectdetection_3d_tpu_torch.dataset.loader import (  # noqa: F401
    DataLoader,
    DetectionBatch,
    PreprocessedDataset,
    StaticBatcher,
)
