"""Small host-side helpers: directories, device and framework names."""

import os


def make_dir(folder_name):
    """Create a directory, doing nothing if it already exists."""
    os.makedirs(folder_name, exist_ok=True)


def convert_device_name(device):
    """Normalize a config's device string to ``"cpu"`` or ``"cuda"``.

    The YAML schema is the JAX package's, so every accelerator spelling it
    accepts (``gpu``, ``cuda``, ``tpu``, ``accelerator``, each with or
    without ``:n``) names the card here.  The result goes to
    ``PointPillars(cfg, device=...)``, which raises when CUDA is absent.
    """
    accel_names = ["gpu", "cuda", "tpu", "accelerator"]
    cpu_names = ["cpu"]
    name = str(device).split(":")[0]
    if name not in cpu_names + accel_names:
        raise KeyError(
            "the device should be one of {} but got {}".format(
                cpu_names + accel_names, device))
    return "cpu" if name in cpu_names else "cuda"


def convert_framework_name(framework):
    """Normalize a framework name; the port runs on PyTorch, so every
    spelling the JAX package accepts names ``"torch"`` here (the JAX
    package's names ``"jax"``)."""
    names = ["jax", "JAX", "tpu", "torch", "pytorch", "PyTorch", "tf",
             "tensorflow", "TF"]
    if framework not in names:
        raise KeyError("unknown framework {}".format(framework))
    return "torch"
