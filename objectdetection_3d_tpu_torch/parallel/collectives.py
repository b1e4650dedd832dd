"""The collectives of the sharded paths, in the three operations that
gloo also takes for CUDA tensors: ``all_reduce``, ``all_gather`` and
``broadcast``.

``all_reduce_sum`` and ``halo_rows`` are autograd functions: the backward
of a sum over ranks sums the cotangent over the same ranks, and the
backward of a halo exchange sends each halo row's gradient back to the
rank that owns the row.
"""

import torch
import torch.distributed as dist


def all_gather(x, group):
    """[x of every rank of ``group``], in rank order (equal shapes).
    (gloo takes bfloat16, float16, int32, uint8 and bool CUDA tensors
    here, not int16.)"""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def all_gather_cat(x, group, dim=0):
    """Every rank's ``x`` of ``group`` concatenated along ``dim``."""
    return torch.cat(all_gather(x, group), dim)


def sum_(x, group):
    """Sum ``x`` in place over ``group`` (no autograd); returns ``x``."""
    dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return sum_(grad.contiguous().clone(), ctx.group), None


def all_reduce_sum(x, group):
    """The sum of ``x`` over the ranks of ``group``, differentiable: the
    cotangent is summed over the same ranks, so every rank's share of a
    global statistic gets the gradient of the whole."""
    return _AllReduceSum.apply(x, group)


class _HaloRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        ctx.args = (dim, group, index, size)
        n = x.shape[dim]
        parts = all_gather(torch.cat([x.narrow(dim, 0, 1),
                                      x.narrow(dim, n - 1, 1)], dim), group)
        zero = torch.zeros_like(x.narrow(dim, 0, 1))
        top = parts[index - 1].narrow(dim, 1, 1) if index > 0 else zero
        bottom = (parts[index + 1].narrow(dim, 0, 1) if index < size - 1
                  else zero)
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, grad):
        dim, group, index, size = ctx.args
        n = grad.shape[dim] - 2
        parts = all_gather(torch.cat([grad.narrow(dim, 0, 1),
                                      grad.narrow(dim, n + 1, 1)], dim),
                           group)
        gx = grad.narrow(dim, 1, n).clone()
        if index > 0:        # my first row was the bottom halo above me
            gx.narrow(dim, 0, 1).add_(parts[index - 1].narrow(dim, 1, 1))
        if index < size - 1:  # my last row was the top halo below me
            gx.narrow(dim, n - 1, 1).add_(parts[index + 1].narrow(dim, 0, 1))
        return gx, None, None, None, None


def halo_rows(x, dim, group, index, size):
    """``x`` (this rank's slab, index ``index`` of ``size`` along ``dim``)
    with one row added on each side of ``dim``: the neighbours' boundary
    rows, zeros at the global edges (a SAME conv's padding).  Every rank
    of ``group`` sends its two boundary rows in one ``all_gather``."""
    return _HaloRows.apply(x, dim, group, index, size)
