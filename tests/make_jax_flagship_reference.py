"""Write ``tests/jax_reference/flagship_predict.npz``: the JAX package's
float32 flagship predict of four clouds, which ``chip_smoke.py``'s phase
22 holds the port's predict on the card against.

    JAX_PLATFORMS=cpu python tests/make_jax_flagship_reference.py

The model is ``__graft_entry__._flagship_cfg`` with ``compute_dtype:
float32`` and the weights of ``artifacts/overfit_ckpt.npz`` with its
``score_thr``; the clouds are ``scene.tree_scene(seed)`` for seeds 0-3
(100,000 points padded to 131,072), each predicted at B = 1 on the CPU.
The file holds ``bbox`` (4, 256, 9), ``label``, ``score`` and ``valid``
(4, 256), and ``provenance``: the JAX version and this command.  It takes
about a minute of CPU.  This script and the CPU tests are the only code
that imports the JAX package for it: phase 22 reads the file with numpy.
``tests/test_torch_port_full_width.py`` regenerates cloud 0 and holds the
file to it.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

OUT = os.path.join(REPO, "tests", "jax_reference", "flagship_predict.npz")
NPZ = os.path.join(REPO, "artifacts", "overfit_ckpt.npz")
SEEDS = (0, 1, 2, 3)
COMMAND = "JAX_PLATFORMS=cpu python tests/make_jax_flagship_reference.py"
KEYS = ("bbox", "label", "score", "valid")


def read_checkpoint(path=NPZ):
    """The npz's flax variables ({"params", "batch_stats"}, nested by its
    ``a/b/c`` keys) and its ``score_thr``."""
    variables = {}
    with np.load(path) as z:
        for key in z.files:
            if key in ("score_thr", "provenance"):
                continue
            node = variables
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
        return variables, float(z["score_thr"])


def jax_model(cfg):
    """The JAX package's ``PointPillars`` of the config dict ``cfg`` with
    the npz's variables and ``score_thr``: (model, variables)."""
    from objectdetection_3d_tpu.models import PointPillars

    variables, score_thr = read_checkpoint()
    model = PointPillars(**cfg)
    model.head_cfg["score_thr"] = score_thr
    return model, variables


def flagship_cfg():
    import __graft_entry__

    return __graft_entry__._flagship_cfg({"compute_dtype": "float32"})


def predict_clouds(seeds=SEEDS):
    """The JAX flagship's float32 predict of ``scene.tree_scene(seed)``
    for each seed, at B = 1: {key: (len(seeds), ...) array}."""
    from objectdetection_3d_tpu_torch.scene import make_batch, tree_scene

    cfg = flagship_cfg()
    model, variables = jax_model(cfg)
    predict = model.make_predict_fn()
    out = {k: [] for k in KEYS}
    for seed in seeds:
        batch = make_batch(tree_scene(seed),
                           cfg["tpu"]["max_points_static"])
        preds = predict(variables, {"points": batch["points"],
                                    "num_points": batch["num_points"]})
        for k in KEYS:
            out[k].append(np.asarray(preds[k])[0])
    return {k: np.stack(v) for k, v in out.items()}


def main():
    import jax

    preds = predict_clouds()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **preds, provenance=np.array(
        f"jax {jax.__version__}, seeds {list(SEEDS)}: {COMMAND}"))
    print(f"{OUT}: valid detections per cloud "
          f"{preds['valid'].sum(axis=1).tolist()}")


if __name__ == "__main__":
    main()
