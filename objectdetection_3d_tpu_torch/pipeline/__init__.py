from objectdetection_3d_tpu_torch.pipeline.pipeline import (  # noqa: F401
    ObjectDetection,
)
from objectdetection_3d_tpu_torch.pipeline.base_pipeline import (  # noqa: F401
    BasePipeline,
)
