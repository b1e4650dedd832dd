"""K11, the vertical encoder's eval-mode stage norm in one pass
(``ops/masked_norm.py``), on the CPU, where its wrapper runs the plain
version.

* The plain version against the eval chain it replaces (mask multiply,
  ``MaskedBatchNorm``, ReLU) at every flagship width, 20 to 196, in
  float32 and float64, within 4 units in the last place of the chain's
  largest term: the chain computes ``((x - mean) * inv) * w + bias`` and
  K11 ``x * a + b`` with ``a``, ``b`` folded from the same statistics, so
  the two round at other places.
* Inactive sites are exactly 0 and negative pre-activations go to 0; bf16
  rounds once, from the float32 result.
* Routing: an eval forward at the flagship's widths and depth runs 10
  norms through K11 under the default knobs (``encoder.norm_fused``
  counts them while a profiler records, and the call sites call the
  wrapper that often), 4 under ``fused_stages`` (K8 runs stages 0-2
  whole); a train forward runs none, keeps the ATen chain and moves the
  running statistics.
* The wrapper refuses what the kernel does not take.

The eval encoder's agreement with the JAX package under each knob set is
``test_torch_port_encoder_kernels.py``'s, which now runs through K11; the
exported predict's operator is ``test_torch_port_serving.py``'s.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from objectdetection_3d_tpu_torch import profiling
from objectdetection_3d_tpu_torch.models import layers
from objectdetection_3d_tpu_torch.models.layers import (
    MaskedBatchNorm,
    SparseMiddleExtractor,
)
from objectdetection_3d_tpu_torch.ops.masked_norm import (
    masked_affine_relu,
    masked_affine_relu_plain,
)

torch.set_num_threads(1)

FLAGSHIP_WIDTHS = (20, 32, 64, 128, 196)


def _bn(c, rng, dtype):
    bn = MaskedBatchNorm(c).to(dtype).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, c)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.3, 3.0, c)))
    return bn


def _grid(rng, c, dtype, shape=(2, 5, 6, 7)):
    """(x NCDHW, mask (B, 1, D, H, W)): x nonzero at inactive sites too,
    as a conv's output is."""
    b, d, h, w = shape
    mask = torch.from_numpy(rng.uniform(size=(b, 1, d, h, w)) < 0.4)
    x = torch.from_numpy(rng.normal(0, 2, (b, c, d, h, w)))
    return x.to(dtype), mask.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c", FLAGSHIP_WIDTHS)
def test_plain_matches_the_eval_chain(c, dtype):
    rng = np.random.default_rng(c)
    bn = _bn(c, rng, dtype)
    x, mask = _grid(rng, c, dtype)
    with torch.no_grad():
        want = F.relu(bn(x * mask, mask))
        got = masked_affine_relu(x.permute(0, 2, 3, 4, 1), mask[:, 0],
                                 *bn.eval_affine(dtype))
    assert got.dtype == dtype and got.is_contiguous()
    got = got.permute(0, 4, 1, 2, 3)
    # the chain's largest term: |x - mean| * inv * w, and the bias
    with torch.no_grad():
        a, b = bn.eval_affine(dtype)
    term = (x.abs().amax() * a.abs().amax() + b.abs().amax()
            + (bn.running_mean * a).abs().amax())
    tol = 4 * torch.finfo(dtype).eps * float(term)
    assert float((got - want).abs().max()) <= tol
    assert bool((got[mask.expand_as(got) == 0] == 0).all())


def test_inactive_sites_are_zero_and_negatives_clamp():
    c = 20
    a = torch.linspace(-2, 2, c)
    b = torch.linspace(1, -1, c)
    x = torch.full((1, 2, 3, 4, c), 3.0)
    x[0, 0, 0, 0] = float("1e30")            # huge, but masked off
    mask = torch.ones((1, 2, 3, 4))
    mask[0, 0, 0, 0] = 0
    mask[0, 1] = 0
    y = masked_affine_relu(x, mask, a, b)
    assert bool((y[0, 1] == 0).all()) and bool((y[0, 0, 0, 0] == 0).all())
    pre = 3.0 * a + b
    live = y[0, 0, 1, 1]
    assert torch.equal(live, torch.clamp(pre, min=0))
    assert bool((live[pre < 0] == 0).all())
    assert bool((live[pre > 0] > 0).all())


def test_bf16_rounds_once_from_float32():
    rng = np.random.default_rng(3)
    x, mask = _grid(rng, 20, torch.bfloat16)
    xn, mn = x.permute(0, 2, 3, 4, 1), mask[:, 0]
    a = torch.from_numpy(rng.uniform(0.5, 1.5, 20).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.3, 20).astype(np.float32))
    got = masked_affine_relu(xn, mn, a, b)
    want = (torch.relu(xn.float() * a + b) * mn.float()[..., None]).to(
        torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(got, masked_affine_relu_plain(xn, mn, a, b))


def _flagship_encoder(knobs, train, b=1):
    """The flagship's encoder widths (20 -> ... -> 196) over D = 100 on an
    8 x 8 image, with its input of ``b`` clouds."""
    tm = SparseMiddleExtractor(20, FLAGSHIP_WIDTHS, **knobs).train(train)
    rng = np.random.default_rng(1)
    mask = torch.from_numpy(
        (rng.uniform(size=(b, 1, 100, 8, 8)) < 0.3).astype(np.float32))
    grid = torch.from_numpy(rng.normal(0, 1, (b, 20, 100, 8, 8)).astype(
        np.float32)) * mask
    return tm, grid, mask


# knob set -> the stages whose two norms K11 runs in an eval forward at
# the flagship depth (K8 runs the others whole)
NORMS = {
    "default": ({}, [0, 1, 2, 3, 4]),
    "fused_stages": ({"fused_stages": True}, [3, 4]),
    "pallas_subm_conv": ({"pallas_subm": True}, [0, 1, 2, 3, 4]),
    "zfold_pallas": ({"zfold_convs": True, "zfold_pallas": True},
                     [0, 1, 2, 3, 4]),
    "decompose_2": ({"decompose_convs": 2, "fused_stages": True},
                    [0, 1, 3, 4]),
}


@pytest.mark.parametrize("knobs", list(NORMS))
def test_eval_forward_runs_each_stage_norm_through_k11(monkeypatch, knobs):
    tpu, stages = NORMS[knobs]
    # each stage's subm norm, then its down norm
    widths = [FLAGSHIP_WIDTHS[i] for i in stages for _ in range(2)]
    calls = []
    real = layers.masked_affine_relu

    def spy(x, mask, a, b):
        calls.append(x.shape[-1])
        return real(x, mask, a, b)

    monkeypatch.setattr(layers, "masked_affine_relu", spy)
    tm, grid, mask = _flagship_encoder(tpu, train=False)
    profiling.counters()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = tm(grid, mask)
    counted = profiling.counters()
    assert tuple(out.shape) == (1, 392, 8, 8)
    assert calls == widths
    assert counted.get("encoder.norm_fused", 0) == len(widths)


@pytest.mark.parametrize("knobs", list(NORMS))
def test_eval_norms_read_contiguous_channels_last_at_batch_2(monkeypatch,
                                                             knobs):
    """Two clouds, the grid in channels_last_3d as the grid build gives
    it: every stage norm's input reaches K11 as a contiguous NDHWC view,
    which the kernel needs on a card (it copies nothing).  The z-fold's
    unfold drops the padded slices of each cloud: a strided view at B > 1
    unless it copies."""
    tpu, stages = NORMS[knobs]
    seen = []
    real = layers.masked_affine_relu

    def spy(x, mask, a, b):
        seen.append((x.shape[-1], x.is_contiguous(), mask.is_contiguous()))
        return real(x, mask, a, b)

    monkeypatch.setattr(layers, "masked_affine_relu", spy)
    tm, grid, mask = _flagship_encoder(tpu, train=False, b=2)
    grid = grid.contiguous(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        out = tm(grid, mask)
    assert tuple(out.shape) == (2, 392, 8, 8)
    assert seen == [(FLAGSHIP_WIDTHS[i], True, True)
                    for i in stages for _ in range(2)]


def test_train_forward_keeps_the_aten_chain(monkeypatch):
    calls = []
    monkeypatch.setattr(layers, "masked_affine_relu",
                        lambda *args: calls.append(1))
    tm, grid, mask = _flagship_encoder({}, train=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()
              if "running" in k}
    out = tm(grid, mask)
    out.square().sum().backward()
    assert not calls
    for k, v in tm.state_dict().items():
        if "running" in k:
            assert not torch.equal(v, before[k]), k
    assert tm.subm_bn_0.weight.grad is not None
    assert float(tm.down_bn_4.bias.grad.abs().sum()) > 0


def test_wrapper_rejects_bad_input():
    x = torch.zeros((1, 2, 3, 4, 20))
    m = torch.zeros((1, 2, 3, 4))
    v = torch.zeros(20)
    with pytest.raises(ValueError):            # float16
        masked_affine_relu(x.half(), m.half(), v, v)
    with pytest.raises(ValueError):            # mask of another shape
        masked_affine_relu(x, m[:, :1], v, v)
    with pytest.raises(ValueError):            # mask of another type
        masked_affine_relu(x, m.bool(), v, v)
    with pytest.raises(ValueError):            # affine of another width
        masked_affine_relu(x, m, v[:19], v)
    with pytest.raises(ValueError):            # affine in bf16
        masked_affine_relu(x, m, v.bfloat16(), v)
    with pytest.raises(ValueError):            # float64 x, float32 affine
        masked_affine_relu(x.double(), m.double(), v, v)
