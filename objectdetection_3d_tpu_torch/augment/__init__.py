from objectdetection_3d_tpu_torch.augment.augmentation import (  # noqa: F401
    Augmentation,
    ObjdetAugmentation,
)
from objectdetection_3d_tpu_torch.augment.numpy_ops import (  # noqa: F401
    global_outlier_check,
)
