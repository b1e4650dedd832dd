"""Predict's two rewrites to static shapes, held against the code they
replace, on the CPU.

* The packed top-k (``models/assign.py::topk_rows_lowest_index``, one
  ``torch.topk`` over an int64 (value, ~index) key) against a copy of the
  former cumsum + ``nonzero`` version, kept here as the oracle: rows with
  many exact ties, -0.0 beside +0.0, -inf, k = 1 and k = n, float32 and
  bf16.  NaN ranks above +inf, all NaNs tying by the lowest index (the
  rank ``torch.topk`` and ``torch.sort`` give it); the former version had
  no consistent answer for NaN (it raised unless the ties below the NaNs
  filled the row), so NaN rows are held against a sort instead.
* The NMS fixpoint as a ``while_loop`` operator (``ops/nms.py``) against
  the former Python loop, on random suppression matrices and on a chain
  of length n (n rounds), in eager mode and through ``torch.export``.

Both are exact: equal index sets and equal keep masks.
"""

import numpy as np
import pytest
import torch

from objectdetection_3d_tpu_torch.models.assign import (
    packed_order_key,
    topk_rows_lowest_index,
)
from objectdetection_3d_tpu_torch.models.detector import topk_lowest_index
from objectdetection_3d_tpu_torch.ops.nms import _greedy_keep

torch.set_num_threads(1)


def _old_topk_rows(key, k):
    """The former ``topk_rows_lowest_index``: the k-th value by
    ``torch.topk``, then the ties below it by a cumsum, read back with
    ``nonzero``."""
    kth = torch.topk(key, k, dim=1).values[:, -1:]
    above = key > kth
    ties = key == kth
    room = k - above.sum(dim=1, keepdim=True)
    take = above | (ties & (torch.cumsum(ties, dim=1, dtype=torch.int32)
                            <= room))
    return take.nonzero()[:, 1].reshape(key.shape[0], k)


def _old_topk_lowest_index(x, k):
    idx = _old_topk_rows(x[None], k)[0]
    order = torch.sort(x[idx], descending=True, stable=True).indices
    return idx[order]


def _rows(seed, g, n, dtype):
    """Rows of few distinct values (many exact ties), with -0.0, +0.0 and
    -inf among them."""
    rng = np.random.default_rng(seed)
    vals = np.array([-np.inf, -3.5, -1.0, -0.0, 0.0, 0.25, 2.0, 7.0],
                    np.float32)
    x = vals[rng.integers(0, len(vals), (g, n))]
    x[0] = rng.normal(size=n).astype(np.float32)      # one row of distinct
    x[1] = -0.0                                       # one row all ties
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", ["1", "7", "n/2", "n"])
def test_packed_topk_equals_the_cumsum_version(dtype, k):
    n = 300
    kk = {"1": 1, "7": 7, "n/2": n // 2, "n": n}[k]
    key = _rows(kk, 6, n, dtype)
    got = topk_rows_lowest_index(key, kk)
    assert got.shape == (6, kk)
    assert torch.equal(got, _old_topk_rows(key, kk))
    for row in key:
        assert torch.equal(topk_lowest_index(row, kk),
                           _old_topk_lowest_index(row, kk))


def test_packed_topk_at_the_steps_prefilter_shape():
    """(16, N) keys with -inf rows of masked GTs and integer-valued ties,
    k = 512, as the assignment's prefilter takes them."""
    rng = np.random.default_rng(1)
    key = rng.integers(-40, 40, (16, 20000)).astype(np.float32)
    key[5:9] = -np.inf
    key = torch.from_numpy(key)
    assert torch.equal(topk_rows_lowest_index(key, 512),
                       _old_topk_rows(key, 512))


def test_packed_key_orders_bf16_as_its_float32_image():
    x = torch.tensor([1.0, -0.0, 0.0, -2.5, float("-inf"), 3.0e38,
                      float("inf")], dtype=torch.bfloat16)
    assert torch.equal(packed_order_key(x), packed_order_key(x.float()))
    # -0.0 and +0.0 tie: their keys differ only in the index bits
    k = packed_order_key(torch.tensor([-0.0, 0.0]))
    assert torch.equal(k >> 32, torch.zeros(2, dtype=torch.int64))


def test_nan_ranks_above_inf_and_nans_tie_by_index():
    nan, inf = float("nan"), float("inf")
    x = torch.tensor([1.0, nan, inf, -nan, 2.0, nan, 2.0, -inf])
    # NaN (either sign) above +inf, lowest index first among the NaNs and
    # among the 2.0s
    assert topk_lowest_index(x, 8).tolist() == [1, 3, 5, 2, 4, 6, 0, 7]
    assert topk_rows_lowest_index(x[None], 4).tolist() == [[1, 2, 3, 5]]
    # against a sort, on random rows with NaN
    rng = np.random.default_rng(4)
    rows = rng.integers(-3, 3, (5, 64)).astype(np.float32)
    rows[rng.random(rows.shape) < 0.1] = np.nan
    for row in rows:
        rank = np.where(np.isnan(row), np.inf, row)
        big = np.isnan(row)
        order = np.lexsort((np.arange(64), ~big, -rank))[:20]
        got = topk_lowest_index(torch.from_numpy(row), 20)
        assert got.tolist() == order.tolist()


def _python_greedy_keep(suppress, valid, rank):
    """The former fixpoint loop, its condition read on the host each
    round."""
    n = valid.shape[0]
    s_upper = (suppress & (rank[:, None] < rank[None, :]) & valid[:, None])
    kept, prev = valid, ~valid
    it = 0
    while it < n and bool((kept != prev).any()):
        blocked = (s_upper & kept[:, None]).any(dim=0)
        kept, prev = valid & ~blocked, kept
        it += 1
    return kept


def _chain(n):
    """Box i suppresses box i + 1 only, ranked in index order: the keep
    set alternates, reached after n rounds."""
    s = torch.zeros((n, n), dtype=torch.bool)
    s[torch.arange(n - 1), torch.arange(1, n)] = True
    return s | s.t(), torch.ones(n, dtype=torch.bool), torch.arange(n)


def _random_case(seed, n, density):
    g = torch.Generator().manual_seed(seed)
    s = torch.rand((n, n), generator=g) < density
    return (s | s.t(), torch.rand(n, generator=g) < 0.8,
            torch.randperm(n, generator=g))


CASES = {"chain-1": lambda: _chain(1), "chain-64": lambda: _chain(64),
         "chain-500": lambda: _chain(500),
         "sparse-200": lambda: _random_case(0, 200, 0.02),
         "dense-200": lambda: _random_case(1, 200, 0.3),
         "none-valid": lambda: (_random_case(2, 50, 0.2)[0],
                                torch.zeros(50, dtype=torch.bool),
                                torch.arange(50))}


@pytest.mark.parametrize("case", CASES)
def test_while_loop_keep_equals_the_python_loop(case):
    suppress, valid, rank = CASES[case]()
    want = _python_greedy_keep(suppress, valid, rank)
    assert torch.equal(_greedy_keep(suppress, valid, rank), want)
    if case.startswith("chain-") and len(valid) > 1:
        assert want.tolist() == [i % 2 == 0 for i in range(len(valid))]


class _Keep(torch.nn.Module):
    def forward(self, suppress, valid, rank):
        return _greedy_keep(suppress, valid, rank)


def test_exported_keep_equals_the_python_loop():
    """One export at n = 64, called on a chain and on random matrices:
    the exported loop runs as many rounds as each input needs."""
    program = torch.export.export(_Keep(), CASES["chain-64"](), strict=False)
    assert any("while_loop" in str(n.target) for n in program.graph.nodes)
    run = program.module()
    for args in (CASES["chain-64"](), _random_case(5, 64, 0.1),
                 _random_case(6, 64, 0.5)):
        assert torch.equal(run(*args), _python_greedy_keep(*args))
