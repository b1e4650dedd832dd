"""PyTorch + CUDA port of objectdetection_3d_tpu for NVIDIA Hopper.

The package mirrors the JAX package's layout (``ops/``, ``models/``,
``dataset/``, ``augment/``, ``pipeline/``) so each module's counterpart
sits at the same relative path.  It imports torch only: nothing of JAX
and nothing of ``objectdetection_3d_tpu``.

What it covers:

* inference, points in and boxes out: voxelize -> point PFN -> grid
  build -> vertical encoder -> sparse RPN -> head -> decode -> NMS
  (``models.detector.PointPillars.predict``);
* the single-device train step, with gradient accumulation
  (``make_train_step(tx, microbatch=)``), and the eval step
  (``make_eval_fn``);
* the host data path (``config``, ``dataset``, ``augment``), metrics,
  ``.pth`` checkpoints and the pipeline (``pipeline.ObjectDetection``:
  ``run_training``, ``run_valid``, ``run_testing``, ``run_inference``),
  with ``python -m objectdetection_3d_tpu_torch.entry {train,test}``.

The ten hand-written CUDA kernels live in ``csrc/`` and are bound in
``ops/``; each wrapper runs its kernel on a CUDA tensor and its plain
PyTorch version on a CPU tensor.
"""
