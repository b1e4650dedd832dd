"""XGBoost booster inference in numpy (no xgboost dependency).

The port's copy of the JAX package's ``models/xgb_infer.py``.  The
reference gates its foreground point filter on a saved XGBoost booster
and predicts through the xgboost C++ library (reference
model/utils.py:107-124).  This module evaluates such a booster directly in
numpy from the standard JSON model format (``Booster.save_model("*.json")``,
xgboost >= 1.0).  The xgboost library, when installed, remains the
preferred path (``models/preprocess_tools.py``).

Supported surface — what the reference actually uses:
- ``gbtree`` boosters (numeric splits; no categorical splits, no dart).
- Objectives ``binary:logistic`` (sigmoid transform, the trunk filter's
  case), ``reg:squarederror``/``reg:linear`` (identity), and raw margin.
- Missing values (NaN) routed via each node's ``default_left``.

The evaluator is vectorized over rows: each tree is walked for all N rows
simultaneously for ``depth`` iterations (leaves self-loop), so prediction
is O(n_trees * depth) numpy gathers instead of a per-row Python loop.
"""

import json

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class _Tree:
    """One regression tree in structure-of-arrays form."""

    __slots__ = ("split_idx", "split_cond", "left", "right",
                 "default_left", "is_leaf", "depth")

    def __init__(self, t):
        self.left = np.asarray(t["left_children"], np.int32)
        self.right = np.asarray(t["right_children"], np.int32)
        self.split_idx = np.asarray(t["split_indices"], np.int32)
        # leaf values live in split_conditions at leaf nodes
        self.split_cond = np.asarray(t["split_conditions"], np.float64)
        self.default_left = np.asarray(t["default_left"], bool)
        self.is_leaf = self.left == -1
        # iteration bound for the vectorized walk: longest root->leaf path
        self.depth = self._max_depth()

    def _max_depth(self):
        """Longest root->leaf path by traversal from the root.

        Node ids are NOT assumed to be in parent-before-child order:
        trees with recycled deleted node slots (pruning,
        tree_param.num_deleted > 0) can place a child at a lower id than
        its parent, which would make a single id-order sweep
        underestimate depth and stop predict() at interior nodes.
        """
        if not len(self.left):
            return 1
        depth = 1
        frontier = [0]
        while frontier:
            nxt = []
            for nid in frontier:
                for child in (self.left[nid], self.right[nid]):
                    if child >= 0:
                        nxt.append(int(child))
            if nxt:
                depth += 1
                if depth > len(self.left):
                    raise ValueError("malformed tree: cycle detected")
            frontier = nxt
        return depth

    def predict(self, x):
        """(N, F) float array (NaN = missing) -> (N,) leaf values."""
        node = np.zeros(x.shape[0], np.int32)
        for _ in range(self.depth):
            feat = x[np.arange(x.shape[0]), self.split_idx[node]]
            missing = np.isnan(feat)
            go_left = np.where(missing, self.default_left[node],
                               feat < self.split_cond[node])
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(self.is_leaf[node], node, nxt).astype(np.int32)
        return self.split_cond[node]


class NumpyBooster:
    """Evaluate a saved xgboost gbtree model with numpy only.

    Mirrors ``xgboost.Booster.load_model`` + ``predict`` for the model
    shapes the reference uses (reference model/utils.py:107-124): load a
    JSON model file, sum tree outputs, add the intercept, apply the
    objective's output transform.
    """

    def __init__(self, trees, base_score, objective, num_feature):
        self.trees = trees
        self.base_score = float(base_score)
        self.objective = objective
        self.num_feature = int(num_feature)

    @classmethod
    def load_model(cls, path):
        with open(path, "rb") as f:
            head = f.read(1)
        if head != b"{":
            raise ValueError(
                "{!r} is not a JSON xgboost model (legacy binary / UBJ "
                "boosters need the xgboost library; re-save with "
                "Booster.save_model('model.json'))".format(path))
        with open(path, "r") as f:
            doc = json.load(f)

        learner = doc["learner"]
        booster_kind = learner["gradient_booster"].get("name", "gbtree")
        if booster_kind != "gbtree":
            # dart would need per-tree weight_drop scaling of each tree's
            # output; summing raw leaves silently predicts wrong values
            raise ValueError("unsupported booster {!r} (only gbtree; dart "
                             "weight_drop scaling is not implemented)"
                             .format(booster_kind))
        model = learner["gradient_booster"]["model"]

        trees = [_Tree(t) for t in model["trees"]]
        for t in model["trees"]:
            if any(int(s) != 0 for s in t.get("split_type", [])):
                raise ValueError("categorical splits are not supported")

        lmp = learner["learner_model_param"]
        # xgboost stores num_class=0 for binary models; any num_class >= 2
        # (multi:softmax/softprob allows num_class=2) means per-class tree
        # groups + softmax, which this evaluator does not implement
        n_class = int(lmp.get("num_class", "0") or "0")
        if n_class >= 2:
            raise ValueError("multiclass boosters are not supported")
        objective = learner["objective"]["name"]
        return cls(trees, float(lmp["base_score"]), objective,
                   int(lmp["num_feature"]))

    def _margin(self, x):
        x = np.asarray(x, np.float64)
        if x.ndim != 2:
            raise ValueError(f"expected (N, F) features, got shape "
                             f"{x.shape}")
        out = np.zeros(x.shape[0], np.float64)
        for tree in self.trees:
            out += tree.predict(x)
        return out

    def predict(self, x, output_margin=False):
        """(N, F) -> (N,) prediction in probability/value space.

        ``base_score`` is stored in the JSON file in the objective's
        *output* space (xgboost >= 1.0 semantics); the margin accumulates
        in link space, so invert the link for the intercept.
        """
        if self.objective == "binary:logistic":
            intercept = np.log(self.base_score / (1.0 - self.base_score))
            margin = self._margin(x) + intercept
            return margin if output_margin else _sigmoid(margin)
        # identity-link objectives (reg:squarederror / reg:linear / margin)
        margin = self._margin(x) + self.base_score
        return margin
