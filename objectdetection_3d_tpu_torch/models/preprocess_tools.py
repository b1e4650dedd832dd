"""Offline preprocessing: density-adaptive voxel downsampling,
normals/FPFH featurization, and the foreground (trunk) point filter.

Port of the JAX package's ``models/preprocess_tools.py``: host-side
data-prep tools that feed the ``.npy`` dataset (SURVEY §3.5), not the
train or predict path.  The voxelizer and the numpy featurizer are copies
of the JAX package's and give the same arrays; the featurizer takes
open3d where it is installed, else the port's C++ library
(``native/``).  The foreground filter's MLP runs on the card unless the
caller passes ``device="cpu"``.
"""

import os
import pickle

import numpy as np
import torch

from objectdetection_3d_tpu_torch import native
from objectdetection_3d_tpu_torch.models.detector import resolve_device
from objectdetection_3d_tpu_torch.models.layers import MLP
from objectdetection_3d_tpu_torch.models.torch_import import (
    mlp_variables_from_torch,
)
from objectdetection_3d_tpu_torch.models.weights import from_jax_variables
from objectdetection_3d_tpu_torch.models.xgb_infer import NumpyBooster


class CustomVoxelizer:
    """Density-adaptive voxel-centroid downsampling of huge clouds
    (reference model/utils.py:8-43 + CustomVoxelGenerator,
    ops/ops_numba.py:83-107).

    If the cloud density exceeds 10 pts/m^3, caps the voxel budget at
    ``min(20000 * e^(0.01 * density) + 70000, N, 3e6)`` and replaces each
    voxel by its point centroid with the point count appended as a final
    feature column.
    """

    def __init__(self, voxel_size, max_voxel_points, reflectance_sampling,
                 **kwargs):
        self.voxel_size = np.asarray(voxel_size, np.float64)
        self.max_voxel_points = int(max_voxel_points)
        self.reflectance_sampling = bool(reflectance_sampling)

    def _bin(self, points, pc_range, max_voxels):
        """Vectorized host binning: sort by cell id, segment means."""
        lo = np.asarray(pc_range[:3])
        cell = np.floor((points[:, :3] - lo) / self.voxel_size).astype(
            np.int64)
        grid = np.maximum(cell.max(axis=0) + 1, 1)
        flat = (cell[:, 0] * grid[1] + cell[:, 1]) * grid[2] + cell[:, 2]

        if self.reflectance_sampling and points.shape[1] > 3:
            order = np.lexsort((-points[:, 3], flat))
        else:
            order = np.argsort(flat, kind="stable")
        flat_s = flat[order]
        pts_s = points[order]

        first = np.concatenate([[True], flat_s[1:] != flat_s[:-1]])
        vox_id = np.cumsum(first) - 1
        n_vox = int(vox_id[-1]) + 1 if len(vox_id) else 0
        keep_vox = min(n_vox, max_voxels)

        starts = np.flatnonzero(first)
        ends = np.concatenate([starts[1:], [len(flat_s)]])
        counts = np.minimum(ends - starts, self.max_voxel_points)

        sums = np.zeros((n_vox, points.shape[1]), np.float64)
        rank = np.arange(len(flat_s)) - starts[vox_id]
        sel = rank < self.max_voxel_points
        np.add.at(sums, vox_id[sel], pts_s[sel])
        centroids = sums[:keep_vox] / counts[:keep_vox, None]
        return centroids, counts[:keep_vox]

    def voxelize(self, point_cloud):
        rng_dims = (point_cloud[:, :3].max(axis=0)
                    - point_cloud[:, :3].min(axis=0))
        density = point_cloud.shape[0] / max(np.prod(rng_dims), 1e-9)
        pc_range = (point_cloud[:, :3].min(axis=0).tolist()
                    + point_cloud[:, :3].max(axis=0).tolist())

        a, b, c = 20000, 0.01, 70000
        voxel_limit = 3_000_000

        if density > 10:
            # exponent capped so extreme densities saturate instead of
            # overflowing (the reference formula overflows above ~7e4 pts/m3)
            budget = a * np.exp(min(b * density, 50.0)) + c
            max_voxels = int(min(budget, point_cloud.shape[0], voxel_limit))
            centroids, counts = self._bin(point_cloud, pc_range, max_voxels)
        elif point_cloud.shape[0] > voxel_limit:
            centroids, counts = self._bin(point_cloud, pc_range, voxel_limit)
        else:
            return point_cloud
        return np.concatenate(
            [centroids, counts.reshape(-1, 1)], axis=1).astype(
                point_cloud.dtype)


def _knn_radius(points, radius, max_nn):
    """Radius-bounded kNN via scipy cKDTree: (N, max_nn) indices
    (self-inclusive) + validity mask."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    dist, idx = tree.query(points, k=max_nn,
                           distance_upper_bound=radius)
    valid = np.isfinite(dist)
    idx = np.where(valid, idx, 0)
    return idx, valid


def estimate_normals(points, radius, max_nn):
    """Per-point unit normals from local PCA (smallest-eigenvector)."""
    idx, valid = _knn_radius(points, radius, max_nn)
    neigh = points[idx]                                # (N, K, 3)
    w = valid[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(axis=1), 1.0)
    mean = (neigh * w).sum(axis=1) / cnt
    d = (neigh - mean[:, None]) * w
    cov = np.einsum("nki,nkj->nij", d, d) / cnt[:, None]
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]
    # orient upward-ish deterministically
    flip = normals[:, 2] < 0
    normals[flip] = -normals[flip]
    return normals


def _darboux(p1, n1, p2, n2):
    """Darboux-frame angle features (alpha, phi, theta) of a point pair."""
    d = p2 - p1
    dist = np.linalg.norm(d, axis=-1, keepdims=True)
    d = d / np.maximum(dist, 1e-12)
    u = n1
    v = np.cross(d, u)
    v_norm = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v / np.maximum(v_norm, 1e-12)
    w = np.cross(u, v)
    alpha = np.einsum("...k,...k->...", v, n2)
    phi = np.einsum("...k,...k->...", u, d)
    theta = np.arctan2(np.einsum("...k,...k->...", w, n2),
                       np.einsum("...k,...k->...", u, n2))
    return alpha, phi, theta


def compute_fpfh(points, normals, radius, max_nn, bins=11):
    """FPFH-33 features (pure numpy fallback for open3d's C++ version,
    reference model/utils.py:82-84).

    Simplified-PFH histograms of the three Darboux angles (11 bins each)
    per point, then the standard distance-weighted neighbor average.
    Returns (N, 33).
    """
    n = points.shape[0]
    idx, valid = _knn_radius(points, radius, max_nn)
    # drop self-pair (first neighbor is the point itself at distance 0)
    p1 = points[:, None, :]
    n1 = normals[:, None, :]
    p2 = points[idx]
    n2 = normals[idx]
    pair_valid = valid.copy()
    pair_valid[:, 0] = False

    alpha, phi, theta = _darboux(p1, n1, p2, n2)
    spfh = np.zeros((n, 3 * bins), np.float64)
    edges_a = np.linspace(-1, 1, bins + 1)
    edges_t = np.linspace(-np.pi, np.pi, bins + 1)
    for f, (feat, edges) in enumerate(
            [(alpha, edges_a), (phi, edges_a), (theta, edges_t)]):
        bin_idx = np.clip(np.searchsorted(edges, feat) - 1, 0, bins - 1)
        for b in range(bins):
            spfh[:, f * bins + b] = np.sum(
                (bin_idx == b) & pair_valid, axis=1)
    cnt = np.maximum(pair_valid.sum(axis=1, keepdims=True), 1)
    spfh = spfh / cnt * 100.0

    # FPFH = SPFH(p) + (1/k) sum_j SPFH(j) / dist_j
    dist = np.linalg.norm(points[idx] - points[:, None], axis=-1)
    wgt = np.where(pair_valid, 1.0 / np.maximum(dist, 1e-6), 0.0)
    neigh_spfh = spfh[idx]                       # (N, K, 33)
    k = np.maximum(pair_valid.sum(axis=1), 1)
    fpfh = spfh + np.einsum("nk,nkf->nf", wgt, neigh_spfh) / k[:, None]
    return fpfh


class Featurizer:
    """Normals + FPFH-33 featurization (reference model/utils.py:46-90).

    Backends: ``"open3d"`` (the reference's own engine), ``"native"`` (the
    port's threaded C++ featurizer, ``native/featurize.cpp``), ``"numpy"``
    (a scipy kd-tree and numpy, the JAX package's fallback, bit for bit),
    or ``"auto"``: open3d where it imports, else native.  The native
    library is built at first use and its build failure raises; a cloud
    it declines (its neighbour grid cannot be built) goes to numpy under
    ``"auto"`` and raises under ``"native"``.
    """

    def __init__(self, normal_rad, normal_max_nn, fpfh_rad, fpfh_max_nn,
                 backend="auto", **kwargs):
        if not (isinstance(normal_rad, float) and isinstance(fpfh_rad, float)):
            raise TypeError("normal_rad and fpfh_rad have to be floats")
        if not (isinstance(normal_max_nn, int)
                and isinstance(fpfh_max_nn, int)):
            raise TypeError("normal_max_nn and fpfh_max_nn have to be ints")
        if backend not in ("auto", "open3d", "native", "numpy"):
            raise ValueError(f"unknown featurizer backend {backend!r}")
        self.normal_rad = normal_rad
        self.normal_max_nn = normal_max_nn
        self.fpfh_rad = fpfh_rad
        self.fpfh_max_nn = fpfh_max_nn
        self.backend = backend

    def generate_features(self, point_cloud):
        """(N, C) cloud -> (N, C + 3 + 33): the cloud, its normals and
        its FPFH-33 features."""
        if not (isinstance(point_cloud, np.ndarray)
                and point_cloud.shape[0] > 0):
            raise ValueError("input has to be a non-empty numpy array")
        if self.backend in ("auto", "open3d"):
            try:
                return self._open3d_features(point_cloud)
            except ImportError:
                if self.backend == "open3d":
                    raise
        if self.backend in ("auto", "native"):
            out = native.featurize_cloud(
                point_cloud.astype(np.float64), self.normal_rad,
                self.normal_max_nn, self.fpfh_rad, self.fpfh_max_nn)
            if out is not None:
                return np.concatenate([point_cloud, *out], axis=1)
            if self.backend == "native":
                raise RuntimeError("the native featurizer declined the "
                                   "cloud (its neighbour grid)")
        xyz = point_cloud[:, :3].astype(np.float64)
        normals = estimate_normals(xyz, self.normal_rad,
                                   self.normal_max_nn)
        fpfh = compute_fpfh(xyz, normals, self.fpfh_rad,
                            self.fpfh_max_nn)
        return np.concatenate([point_cloud, normals, fpfh], axis=1)

    def _open3d_features(self, point_cloud):
        import open3d as o3d

        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(point_cloud[:, :3])
        pcd.estimate_normals(o3d.geometry.KDTreeSearchParamHybrid(
            radius=self.normal_rad, max_nn=self.normal_max_nn))
        normals = np.asarray(pcd.normals)
        fpfh = o3d.pipelines.registration.compute_fpfh_feature(
            pcd, o3d.geometry.KDTreeSearchParamHybrid(
                radius=self.fpfh_rad, max_nn=self.fpfh_max_nn))
        return np.concatenate(
            [np.concatenate([point_cloud, normals], axis=1), fpfh.data.T],
            axis=1)


class ForegroundFilter:
    """Trunk-point classifier gate (reference model/utils.py:92-133).

    ``filter_type == 'mlp'``: the port's ``MLP`` on ``device`` (the card
    unless the caller passes ``"cpu"``), its weights from
    ``<path>mlp.pkl`` (the JAX package's flax variables as numpy arrays)
    or else ``<path>mlp.pth`` (the reference's state dict); it reads the
    trailing ``input_channels`` feature columns (the JAX package's filter
    takes exactly ``input_channels`` columns and raises on more: ROADMAP
    C11).
    ``'xgboost'``: a saved booster through the xgboost library where it
    imports and can read the file, else through the numpy evaluator of
    the JSON model format (``models/xgb_infer.py``).  A missing
    checkpoint raises ``FileNotFoundError``, a bad config ``ValueError``.
    """

    def __init__(self, cfg, device="cuda"):
        self.path = cfg.get("path", None)
        self.filter_type = cfg.get("filter_type", None)
        if self.filter_type not in ("xgboost", "mlp"):
            raise ValueError("the trunk-point filter has to be xgboost or "
                             "mlp")
        self.filter_cfg = dict(cfg[self.filter_type])
        self.trunk_prob = self.filter_cfg.get("trunk_confidence")
        if not (isinstance(self.trunk_prob, float)
                and 0 < self.trunk_prob < 1):
            raise ValueError(f"trunk_confidence {self.trunk_prob!r} has to "
                             f"be a float in (0, 1)")
        self.device = resolve_device(device)
        self.init_model()

    def init_model(self):
        if self.filter_type == "xgboost":
            model_path = "{}{}".format(self.path, self.filter_type)
            if not os.path.exists(model_path) and \
                    os.path.exists(model_path + ".json"):
                model_path = model_path + ".json"
            try:
                import xgboost as xgb

                self.foreground_filter = xgb.Booster()
                self.foreground_filter.load_model(model_path)
                self._xgb_native = True
            except Exception:
                # no xgboost library, or one too old to read this file
                # (a *.json saved by a newer version): the numpy
                # evaluator reads JSON models
                self.foreground_filter = NumpyBooster.load_model(model_path)
                self._xgb_native = False
            return
        pkl_path = "{}{}.pkl".format(self.path, self.filter_type)
        pth_path = "{}{}.pth".format(self.path, self.filter_type)
        if os.path.exists(pkl_path):
            # a numpy variable tree this program or the JAX package wrote
            with open(pkl_path, "rb") as f:
                variables = pickle.load(f)
        elif os.path.exists(pth_path):
            variables = mlp_variables_from_torch(pth_path)
        else:
            raise FileNotFoundError(
                "no MLP checkpoint at {} (.pkl or .pth)".format(
                    pkl_path[:-4]))
        in_ch = np.asarray(variables["params"]["dense_0"]["kernel"]).shape[0]
        self.mlp = MLP(input_channels=int(
            self.filter_cfg.get("input_channels", in_ch)))
        from_jax_variables(self.mlp, variables)
        self.mlp.to(self.device).eval()

    def probabilities(self, features):
        """(N, C) features -> (N,) trunk probabilities (float32 from the
        MLP, float64 from a booster)."""
        if self.filter_type == "xgboost":
            if self._xgb_native:
                import xgboost as xgb

                return self.foreground_filter.predict(xgb.DMatrix(features))
            return self.foreground_filter.predict(
                np.asarray(features, np.float64))
        # the MLP reads the trailing input_channels columns: with the
        # reference's 37, reflectance, normals and FPFH-33 of an (x, y, z,
        # reflectance) cloud's 40 feature columns
        in_ch = self.mlp.dense_0.in_features
        x = torch.as_tensor(np.asarray(features, np.float32)[:, -in_ch:],
                            device=self.device)
        with torch.inference_mode():
            return self.mlp(x)[:, 0].cpu().numpy()

    def evaluate(self, features):
        """(N, C) features -> (N,) uint8 foreground mask."""
        return (self.probabilities(features) > self.trunk_prob).astype(
            np.uint8)
