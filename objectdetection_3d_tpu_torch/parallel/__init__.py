"""Data and spatial parallelism over ``torch.distributed`` (the JAX
package's ``parallel`` names; see ``data_parallel.py``)."""

from objectdetection_3d_tpu_torch.parallel.data_parallel import (  # noqa: F401
    Mesh,
    make_mesh,
    make_mesh_2d,
    make_sharded_eval_fn,
    make_sharded_predict_fn,
    make_sharded_train_step,
    make_spatial_predict_fn,
)
from objectdetection_3d_tpu_torch.parallel.launch import spawn  # noqa: F401
