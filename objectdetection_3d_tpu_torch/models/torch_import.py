"""Import the reference PyTorch checkpoints into the port.

The reference ships training checkpoints ``{epoch, model_state_dict,
optimizer_state_dict}`` (reference pipeline/pipeline.py:36-50) of its
spconv ``PointPillars``, and its foreground-filter MLP as
``model/models/mlp.pth`` (reference model/utils.py:107-124).  Port of the
JAX package's ``models/torch_import.py``: a state dict becomes the JAX
package's ``{"params", "batch_stats"}`` tree of numpy arrays, which
``models/weights.from_jax_variables`` loads into the port's
``PointPillarsNet`` or ``MLP``.

Layout conversions (reference -> tree):

* ``nn.Linear``    weight (out, in)            -> Dense kernel (in, out)
* ``nn.Conv2d``    weight (out, in, kh, kw)    -> Conv kernel (kh, kw, in, out)
* ``spconv.SubMConv3d`` (v2.x KRSC layout)
                   weight (out, kd, kh, kw, in) -> kernel (kd, kh, kw, in, out)
* ``spconv.SubMConv2d`` weight (out, kh, kw, in) -> kernel (kh, kw, in, out)
* ``spconv.SparseConv3d`` (3,1,1) weight (out, 3, 1, 1, in) -> (3, in, out)
* ``nn.BatchNorm``  weight/bias/running_mean/running_var ->
                    scale/bias (params) + mean/var (batch_stats)
"""

import os

import numpy as np
import torch

from objectdetection_3d_tpu_torch.models.weights import from_jax_variables


def load_torch_state_dict(path):
    """Load a torch ``.pth`` file as a flat {name: numpy} dict.

    Accepts both a bare state dict and the reference's
    ``{"model_state_dict": ...}`` checkpoint envelope
    (reference pipeline/pipeline.py:44-49).
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in ckpt.items()
            if torch.is_tensor(v)}


def _state_dict(state_dict_or_path):
    if isinstance(state_dict_or_path, (str, os.PathLike)):
        return load_torch_state_dict(state_dict_or_path)
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v))
            for k, v in state_dict_or_path.items()}


def _bn(sd, prefix):
    """(params, stats) pair of one torch BatchNorm."""
    params = {"scale": sd[prefix + ".weight"].astype(np.float32),
              "bias": sd[prefix + ".bias"].astype(np.float32)}
    stats = {"mean": sd[prefix + ".running_mean"].astype(np.float32),
             "var": sd[prefix + ".running_var"].astype(np.float32)}
    return params, stats


def mlp_variables_from_torch(state_dict_or_path):
    """Reference foreground-filter MLP (model/mlp.py) state dict -> the
    variable tree of ``models.layers.MLP``: torch names
    ``hidden{1..5}`` / ``bn{1..5}`` / ``hidden6`` map onto ``dense_{0..4}``
    / ``bn_{0..4}`` / ``out``."""
    sd = _state_dict(state_dict_or_path)
    params, stats = {}, {}
    for i in range(5):
        params[f"dense_{i}"] = {
            "kernel": sd[f"hidden{i + 1}.weight"].T.astype(np.float32),
            "bias": sd[f"hidden{i + 1}.bias"].astype(np.float32),
        }
        params[f"bn_{i}"], stats[f"bn_{i}"] = _bn(sd, f"bn{i + 1}")
    params["out"] = {
        "kernel": sd["hidden6.weight"].T.astype(np.float32),
        "bias": sd["hidden6.bias"].astype(np.float32),
    }
    return {"params": params, "batch_stats": stats}


def load_reference_mlp(mlp, path_or_state_dict):
    """Load a reference-layout ``mlp.pth`` (a path, bare state dict or
    checkpoint envelope) or a {name: array} state dict into the port's
    ``MLP`` ``mlp``; a missing weight raises ``KeyError``, a width that
    does not match ``mlp`` ``ValueError``."""
    from_jax_variables(mlp, mlp_variables_from_torch(path_or_state_dict))


def _conv2d_kernel(w):
    """torch / spconv-2d weight -> (kh, kw, in, out).

    torch ``nn.Conv2d`` stores (out, in, kh, kw); spconv v2 ``SubMConv2d``
    stores channels-last (out, kh, kw, in).  The two are told apart by
    which axes hold the (square, small) kernel taps.
    """
    w = np.asarray(w, np.float32)
    if w.shape[1] == w.shape[2]:  # (out, kh, kw, in) spconv KRSC
        return np.transpose(w, (1, 2, 3, 0))
    return np.transpose(w, (2, 3, 1, 0))  # (out, in, kh, kw) torch


def pointpillars_variables_from_torch(state_dict_or_path, num_pfn_layers,
                                      num_middle_stages, num_rpn_convs):
    """Reference ``PointPillars`` state dict -> the JAX package's variable
    tree for ``PointPillarsNet`` (active path: voxel_encoder ->
    pseudoimage_generator -> sparse_rpn -> bbox_head; the bypassed dense
    backbone/neck weights are ignored, reference
    model/PointPillars.py:101-103).

    Args:
        state_dict_or_path: a ``.pth`` path or a {name: array} dict.
        num_pfn_layers: len(pfn feat_channels).
        num_middle_stages: len(vertical_encoder out_channels).
        num_rpn_convs: sum(1 + n for n in backbone layer_nums).
    Returns:
        {"params": ..., "batch_stats": ...} of float32 numpy arrays.
    Raises:
        KeyError: naming a reference weight the state dict lacks.
    """
    sd = _state_dict(state_dict_or_path)
    params, stats = {}, {}

    # --- PillarFeatureNet: pfn_layers.{i}.linear/.norm ------------------
    ve_p, ve_s = {}, {}
    for i in range(num_pfn_layers):
        base = f"voxel_encoder.pfn_layers.{i}"
        ve_p[f"pfn_{i}"] = {
            "linear": {"kernel":
                       sd[base + ".linear.weight"].T.astype(np.float32)},
        }
        bn_p, bn_s = _bn(sd, base + ".norm")
        ve_p[f"pfn_{i}"]["norm"] = bn_p
        ve_s[f"pfn_{i}"] = {"norm": bn_s}
    params["voxel_encoder"] = ve_p
    stats["voxel_encoder"] = ve_s

    # --- vertical encoder: middle_conv SparseSequential ------------------
    # stage i occupies indices [6i..6i+5]: SubMConv3d, BN, ReLU,
    # SparseConv3d, BN, ReLU (reference model/PointPillars.py:545-558)
    mid_p, mid_s = {}, {}
    for i in range(num_middle_stages):
        base = "pseudoimage_generator.middle_conv"
        w = np.asarray(sd[f"{base}.{6 * i}.weight"], np.float32)
        # spconv v2 KRSC (out, kd, kh, kw, in) -> (kd, kh, kw, in, out)
        mid_p[f"subm_{i}_kernel"] = np.transpose(w, (1, 2, 3, 4, 0))
        bn_p, bn_s = _bn(sd, f"{base}.{6 * i + 1}")
        mid_p[f"subm_bn_{i}"] = bn_p
        mid_s[f"subm_bn_{i}"] = bn_s

        wd = np.asarray(sd[f"{base}.{6 * i + 3}.weight"], np.float32)
        # (out, 3, 1, 1, in) -> (3, in, out)
        mid_p[f"down_{i}_kernel"] = np.transpose(wd[:, :, 0, 0, :],
                                                 (1, 2, 0))
        bn_p, bn_s = _bn(sd, f"{base}.{6 * i + 4}")
        mid_p[f"down_bn_{i}"] = bn_p
        mid_s[f"down_bn_{i}"] = bn_s
    params["pseudoimage_generator"] = mid_p
    stats["pseudoimage_generator"] = mid_s

    # --- sparse RPN: blocks.{3k} conv / {3k+1} BN -------------------------
    rpn_p, rpn_s = {}, {}
    for k in range(num_rpn_convs):
        rpn_p[f"conv_{k}"] = {
            "kernel": _conv2d_kernel(sd[f"sparse_rpn.blocks.{3 * k}.weight"])}
        bn_p, bn_s = _bn(sd, f"sparse_rpn.blocks.{3 * k + 1}")
        rpn_p[f"bn_{k}"] = bn_p
        rpn_s[f"bn_{k}"] = bn_s
    params["sparse_rpn"] = rpn_p
    stats["sparse_rpn"] = rpn_s

    # --- head: conv_cls / conv_reg / 3 direction convs --------------------
    head = {}
    for ours, theirs in (("conv_cls", "bbox_head.conv_cls"),
                         ("conv_reg", "bbox_head.conv_reg")):
        head[ours] = {
            "kernel": _conv2d_kernel(sd[theirs + ".weight"]),
            "bias": sd[theirs + ".bias"].astype(np.float32),
        }
    # the single conv_dir orders channels per anchor as (x0, x1, y0, y1,
    # z0, z1); the reference concatenates three (A*2) convs along channels
    # (model/PointPillars.py:884): interleave them
    wx, wy, wz = (_conv2d_kernel(sd[f"bbox_head.conv_dir_cls_{ax}.weight"])
                  for ax in "xyz")
    bx, by, bz = (sd[f"bbox_head.conv_dir_cls_{ax}.bias"].astype(np.float32)
                  for ax in "xyz")
    num_anchors = wx.shape[-1] // 2
    cin = wx.shape[2]
    wk = np.stack([w.reshape(cin, num_anchors, 2)
                   for w in (wx[0, 0], wy[0, 0], wz[0, 0])],
                  axis=2)  # (in, A, 3, 2)
    bk = np.stack([b.reshape(num_anchors, 2) for b in (bx, by, bz)],
                  axis=1)  # (A, 3, 2)
    head["conv_dir"] = {
        "kernel": wk.reshape(1, 1, cin, num_anchors * 6).astype(np.float32),
        "bias": bk.reshape(num_anchors * 6).astype(np.float32),
    }
    params["bbox_head"] = head

    return {"params": params, "batch_stats": stats}


def layer_counts(net):
    """(PFN layers, vertical-encoder stages, RPN convs) of a port
    ``PointPillarsNet``, read from its parameter names."""
    names = [name for name, _ in net.named_parameters()]

    def count(prefix, suffix):
        return sum(n.startswith(prefix) and n.endswith(suffix)
                   for n in names)

    return (count("voxel_encoder.pfn_", ".linear.weight"),
            count("pseudoimage_generator.subm_", "_kernel"),
            count("sparse_rpn.conv_", ".weight"))


def load_reference_pth(net, path_or_state_dict):
    """Load the reference detector's weights into the port's
    ``PointPillarsNet`` ``net``: a ``.pth`` path (bare state dict or the
    reference's checkpoint envelope) or a {name: array} state dict.

    Every parameter and running statistic of ``net`` is written; a
    reference weight the source lacks raises ``KeyError`` naming it, a
    width that does not match ``net`` raises ``ValueError``.
    """
    tree = pointpillars_variables_from_torch(path_or_state_dict,
                                             *layer_counts(net))
    from_jax_variables(net, tree)
