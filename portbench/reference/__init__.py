"""The plain reference that the output check holds the program to.

An architecture is a module of this folder.  A configuration file names
its own by a top-level ``"architecture": "<name>"``, which the harness
loads by path as ``portbench/reference/<name>.py`` under the checkout
root (``harness/plugins.py``); a file that names none runs
:mod:`portbench.reference.model`.  The harness, the tiled and the train
reference (``tiles.py``, ``train.py``) and ``calibrate.py`` reach the
architecture only through this contract, so a configuration of another
architecture comes as files alone.  The module provides:

* ``Spec(model_cfg)``: the sizes it needs from the configuration's
  ``model`` dict;
* ``param_shapes(spec)``: {state-dict name: shape} of every parameter and
  running statistic, the leaves the benchmark draws or reads and copies
  into the program's network;
* ``anchors(spec, device)``: the (N, 9) anchors of the head;
* ``predict(points, n, params, spec, anchors, quant)``: the eval forward,
  decode and NMS of one cloud, with what ``harness/compare.py`` reads:
  ``bbox`` (K, 9) boxes with the three direction bins applied, ``score``,
  ``label``, ``valid``, and every anchor's ``logit``, ``reg`` (its 9
  deltas) and ``anchor``, and the ``cut_logit`` of the last candidate;
* ``identity`` and ``fp8``: the ``quant`` of the reference and of the
  control of ``correct``;
* ``forward_flops(model_cfg)``: {stage: forward FLOPs of one cloud} and
  ``total``, and ``encoder_bytes(model_cfg)``, the encoder's least bytes;
  the per-layer readers take ``total`` and ``encoder`` from them;
* ``top_lowest_index``, ``greedy_nms``, ``overlap_matrix`` (the tiled
  reference's merge) and ``encode``, ``forward`` (the train reference);
* optionally ``call_work(spec, cloud)``: the same counts as
  ``forward_flops`` with ``encoder_bytes`` as one more key, counted from
  one cloud's own active sites, where the architecture computes only at
  those (rulebook convolutions).  ``cloud`` is an (N, C) float32 tensor on
  the device; rows outside the range count for nothing, as the voxelizer
  drops them.  Where it is given, a ``--trace 1`` run reads the mean of
  the profiled calls' clouds in place of the static counts;

The port builds every architecture as ``PointPillars(model)``: its
encoder is the network's ``pseudoimage_generator`` and its head the
``bbox_head``, whose boundaries time a predict's stages.
"""
