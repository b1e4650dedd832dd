"""The work a configuration of :mod:`portbench.reference.model` asks of
the device, counted from its shapes, and the card's published peaks.

Every convolution and linear layer is counted dense at the configured
grid: 2 x (output sites) x (input channels) x (kernel taps) x (output
channels).  That is the work these architectures define: their vertical
encoder and RPN are dense masked convolutions, which compute every site
of the grid and zero the empty ones, so the dense count is the work,
whatever implements it.  An architecture whose convolutions run on
rulebooks computes only at active sites, a small share of the grid;
it counts those sites per call in its own ``call_work``
(:mod:`portbench.reference`), and the dense count would credit it many
times the work it defines.  Elementwise work, batch norms, voxelize,
decode and NMS are not counted.
"""

import math

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "bf16": 2, "float16": 2, "float32": 4}


def _depths(d, stages):
    out = [d]
    for _ in range(stages):
        d = (d - 3) // 2 + 1
        out.append(d)
    return out


def encoder_flops(model):
    """Forward FLOPs of the vertical encoder: per stage a 3x3x3 conv over
    the stage's full grid and a (3, 1, 1) conv at stride (2, 1, 1)."""
    pcr = model["point_cloud_range"]
    vs = model["voxelize"]["voxel_size"]
    gx, gy, gz = (int(round((pcr[3 + i] - pcr[i]) / vs[i]))
                  for i in range(3))
    chans = [int(c) for c in model["vertical_encoder"]["out_channels"]]
    cin = int(model["vertical_encoder"]["in_channels"])
    d = _depths(gz, len(chans))
    total = 0
    for i, co in enumerate(chans):
        total += 2 * d[i] * gy * gx * cin * 27 * co
        total += 2 * d[i + 1] * gy * gx * co * 3 * co
        cin = co
    return total


def encoder_bytes(model):
    """Least bytes the encoder must move: the dense grid read once, the
    pseudo-image written once (both in the compute type) and the float32
    weights read once."""
    pcr = model["point_cloud_range"]
    vs = model["voxelize"]["voxel_size"]
    gx, gy, gz = (int(round((pcr[3 + i] - pcr[i]) / vs[i]))
                  for i in range(3))
    chans = [int(c) for c in model["vertical_encoder"]["out_channels"]]
    cin = int(model["vertical_encoder"]["in_channels"])
    e = DTYPE_BYTES[model["tpu"]["compute_dtype"]]
    d_out = _depths(gz, len(chans))[-1]
    weights, c = 0, cin
    for co in chans:
        weights += 4 * (27 * c * co + 3 * co * co + 4 * co)
        c = co
    return e * gz * gy * gx * cin + e * chans[-1] * d_out * gy * gx + weights


def _rpn_flops(model, h, w, cin):
    bb = model["backbone"]
    total = 0
    for co, extra in zip(bb["out_channels"], bb["layer_nums"]):
        for _ in range(1 + int(extra)):
            total += 2 * h * w * cin * 9 * int(co)
            cin = int(co)
    return total, cin


def _dense_flops(model, h, w, cin):
    """Backbone (strided 3x3 convs) and neck (transposed convs of kernel
    = stride: each input site feeds stride^2 outputs)."""
    bb, neck = model["backbone"], model["neck"]
    total, stages = 0, []
    for co, extra, s in zip(bb["out_channels"], bb["layer_nums"],
                            bb["layer_strides"]):
        for j in range(1 + int(extra)):
            if j == 0:
                h, w = -(-h // int(s)), -(-w // int(s))
            total += 2 * h * w * cin * 9 * int(co)
            cin = int(co)
        stages.append((h, w, cin))
    head_in = 0
    for (sh, sw, c), co, s in zip(stages, neck["out_channels"],
                                  neck["upsample_strides"]):
        total += 2 * sh * sw * c * int(s) ** 2 * int(co)
        head_in += int(co)
    return total, head_in


def forward_flops(model):
    """{stage: forward FLOPs} of one cloud, and ``total``."""
    pcr = model["point_cloud_range"]
    vs = model["voxelize"]["voxel_size"]
    gx, gy, gz = (int(round((pcr[3 + i] - pcr[i]) / vs[i]))
                  for i in range(3))
    pfn = model["voxel_encoder"]["feat_channels"]
    points = int(model["tpu"]["max_points_static"])
    out = {"pfn": 2 * points * (int(model["voxel_encoder"]["in_channels"])
                                + 5) * (int(pfn[-1]) - 1),
           "encoder": encoder_flops(model)}
    chans = model["vertical_encoder"]["out_channels"]
    cin = int(chans[-1]) * _depths(gz, len(chans))[-1]
    if model.get("use_dense_backbone"):
        out["backbone_neck"], head_in = _dense_flops(model, gy, gx, cin)
        ups = [int(s) for s in model["neck"]["upsample_strides"]]
        factor = math.prod(int(s) for s in
                           model["backbone"]["layer_strides"]) // ups[-1]
        fh, fw = gy // factor, gx // factor
    else:
        out["rpn"], head_in = _rpn_flops(model, gy, gx, cin)
        fh, fw = gy, gx
    anchors = len(model["head"]["sizes"]) * len(model["head"]["rotations"])
    n_cls = max(len(model.get("classes", ())), 1)
    out["head"] = 2 * fh * fw * head_in * anchors * (n_cls + 9 + 6)
    out["total"] = sum(out.values())
    return out
