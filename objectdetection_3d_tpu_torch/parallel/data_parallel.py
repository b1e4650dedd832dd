"""Data and spatial parallelism over ``torch.distributed``.

Port of the JAX package's ``parallel/data_parallel.py`` with torch's
idiom inside: one process per rank, process groups where the JAX package
has a ``Mesh``, and explicit collectives where GSPMD inserts them.

* ``make_mesh(n)`` / ``make_mesh_2d(n_data, n_space)``: this rank's place
  in a (data x space) grid of ranks (rank = data * n_space + space), its
  data group (the ranks of its space index), its space group (the ranks
  of its data index) and its device.
* ``make_sharded_train_step``: each rank takes its rows of the global
  batch (and, with ``space_axis``, a slab of the pseudo-image's H).  The
  masked batch norms sum their statistics over the ranks with autograd,
  the losses are normalized by the global positive count, and the
  gradients are summed over the ranks in one ``all_reduce`` per dtype
  before the clip and AdamW: the step equals the one-device step on the
  global batch, and the replicas stay equal.
* ``make_sharded_eval_fn`` / ``make_sharded_predict_fn``: data-parallel
  eval and predict; every rank returns the global batch's outputs.
* ``make_spatial_predict_fn``: the batch over ``data`` and H over
  ``space``, with a one-row halo exchange before every 3x3(x3) conv.
  The gather encoder (``tpu.sparse_middle``) runs whole on every space
  rank, which keeps its slab of the pseudo-image; the dense backbone
  (``use_dense_backbone``) takes one halo row before each of its 3x3
  convs, strided ones included, where ``H / n_space`` is a multiple of
  the product of its strides (else ``ValueError``; ROADMAP C14).

Every kernel of the one-device path stays live on the data-parallel
paths.  On the spatial paths the encoder runs its default lowering (K8-K10
are not used, as the JAX package's spatial programs run
``_net_for("off")``); K1 and K2 stay live.
"""

import contextlib
import logging
import os

import torch
import torch.distributed as dist

from objectdetection_3d_tpu_torch.models.layers import MaskedBatchNorm
from objectdetection_3d_tpu_torch.parallel import collectives
from objectdetection_3d_tpu_torch.parallel.launch import default_backend

log = logging.getLogger(__name__)

ENCODER_KERNEL_KNOBS = ("fused_stages", "pallas_subm_conv", "zfold_pallas")
_knob_warned = set()


def init_distributed(backend=None, device=None):
    """Join the process group of this process's environment, unless it
    has joined one: ``torchrun`` (or ``parallel.launch.spawn``) sets
    ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR``/``MASTER_PORT``; a process
    without them is a world of one.  ``backend`` defaults to
    ``launch.default_backend(device)``: nccl on the cards, gloo on the
    CPU or where the host's ranks outnumber its cards."""
    if dist.is_initialized():
        return
    dev = torch.device(device if device is not None else local_device())
    backend = backend or default_backend(dev)
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def local_device():
    """``cuda:LOCAL_RANK % device_count()``; raises where there is no card
    (the caller passes ``device="cpu"`` for the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh runs on the card by default, and CUDA "
                           "is not available; pass device='cpu' to run on "
                           "the CPU")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def world_size():
    """The world size of the joined group, else of the environment."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


class Mesh:
    """This rank's place in an (n_data x n_space) grid of ranks.

    Attributes:
        world_group, data_group, space_group: process groups (the data
            group holds the ranks of this rank's space index, the space
            group those of its data index).
        data_index, space_index: this rank's coordinates.
        device: where this rank runs.
    """

    axis_names = ("data", "space")

    def __init__(self, n_data, n_space, backend=None, device=None):
        need = n_data * n_space
        have = world_size()
        if have != need:
            raise ValueError(
                f"requested a {n_data}x{n_space} mesh of {need} ranks but "
                f"the world has {have} (run one process per rank: "
                f"torchrun --nproc_per_node={need}, or parallel.launch."
                f"spawn)")
        self.device = torch.device(device if device is not None
                                   else local_device())
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        init_distributed(backend, self.device)
        self.n_data, self.n_space = int(n_data), int(n_space)
        self.rank = dist.get_rank()
        self.data_index, self.space_index = divmod(self.rank, n_space)
        self.world_group = dist.group.WORLD
        # every rank creates every group, in the same order
        for s in range(n_space):
            g = dist.new_group([d * n_space + s for d in range(n_data)])
            if s == self.space_index:
                self.data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_space + s for s in range(n_space)])
            if d == self.data_index:
                self.space_group = g

    @property
    def shape(self):
        return {"data": self.n_data, "space": self.n_space}

    def rows(self, n, axis="data"):
        """(lo, hi) of this rank's block of ``n`` along ``axis``."""
        parts = self.n_data if axis == "data" else self.n_space
        index = self.data_index if axis == "data" else self.space_index
        if n % parts:
            raise ValueError(f"{n} is not divisible by the {axis!r} axis "
                             f"size {parts}")
        k = n // parts
        return index * k, (index + 1) * k


def make_mesh(n_devices=None, backend=None, device=None):
    """1-D mesh: ``n_devices`` data-parallel ranks (default: the world).
    A world of another size raises ``ValueError``, as the JAX package
    refuses to shrink a mesh."""
    return Mesh(world_size() if n_devices is None else int(n_devices), 1,
                backend, device)


def make_mesh_2d(n_data, n_space, backend=None, device=None):
    """2-D (data x space) mesh: the batch over ``data``, the pseudo-image's
    H over ``space``."""
    return Mesh(int(n_data), int(n_space), backend, device)


def _summer(group):
    return lambda t: collectives.all_reduce_sum(t, group)


class Shard:
    """One rank's part of a sharded step (``PointPillars.make_train_step``
    takes it as ``shard``).

    Args:
        mesh: the rank's :class:`Mesh`.
        model: the ``PointPillars``.
        spatial: split the pseudo-image's H over the space group.
    """

    def __init__(self, mesh, model, spatial=False):
        self.mesh = mesh
        self.spatial = bool(spatial)
        # the ranks whose rows differ: data x space on the spatial path,
        # else the data group (space ranks then repeat the same work)
        self.group = mesh.world_group if spatial else mesh.data_group
        self.rows = self.anchor_rows = None
        if spatial:
            _, h, w = model.grid_dhw
            if model.net.use_dense_backbone:
                # every stage's slab must start on a row its stride
                # keeps, so one halo row serves every strided conv
                stride = model.net.backbone.total_stride
                if h % (mesh.n_space * stride):
                    raise ValueError(
                        f"the spatial path splits H = {h} over "
                        f"{mesh.n_space} space ranks, and the dense "
                        f"backbone needs H / n_space to be a multiple of "
                        f"prod(layer_strides) = {stride} (ROADMAP C14)")
            self.rows = mesh.rows(h, "space")
            # the featmap's rows (the neck's resolution under the dense
            # backbone) and its anchors
            fh, fw = model.featmap
            lo, hi = (r * fh // h for r in self.rows)
            per_row = fw * model.num_anchors
            self.anchor_rows = (lo * per_row, hi * per_row)
            _warn_unused_knobs(model)

    def batch_rows(self, n):
        """(lo, hi) of this rank's items of a global batch of ``n``."""
        return self.mesh.rows(n, "data")

    @contextlib.contextmanager
    def context(self, net):
        """Inside: ``net``'s masked batch norms sum their training
        statistics over the ranks (the PFN's, and the gather encoder's,
        over the data group: they run on the same voxels on every space
        rank), and on the spatial path the grid build (or, after the
        gather encoder, the pseudo-image) keeps this rank's rows and the
        3x3(x3) convs of the dense encoder and of the RPN or the dense
        backbone exchange a halo row with the neighbours."""
        mesh = self.mesh
        bns = [m for m in net.modules() if isinstance(m, MaskedBatchNorm)]
        # what every space rank computes whole: the PFN, and the gather
        # encoder on the spatial path
        whole = set(net.voxel_encoder.modules())
        halos = []
        if self.spatial:
            halos.append(net.backbone if net.use_dense_backbone
                         else net.sparse_rpn)
            if net.sparse_middle:
                whole |= set(net.pseudoimage_generator.modules())
            else:
                halos.append(net.pseudoimage_generator)
        for m in bns:
            m.stats_sum = _summer(mesh.data_group if m in whole
                                  else self.group)
        if self.spatial:
            def halo(x, dim):
                return collectives.halo_rows(x, dim, mesh.space_group,
                                             mesh.space_index, mesh.n_space)
            net.rows = self.rows
            for m in halos:
                m.halo = halo
        try:
            yield
        finally:
            for m in bns:
                del m.stats_sum
            if self.spatial:
                del net.rows
                for m in halos:
                    del m.halo

    def num_pos_sum(self, num_pos):
        """The batch's positive count over the data group (each space
        rank assigns its items over every anchor), without autograd."""
        return collectives.sum_(num_pos.detach().clone(),
                                self.mesh.data_group)

    @torch.no_grad()
    def sum_grads(self, params):
        """Sum every gradient over the ranks: one ``all_reduce`` of a flat
        buffer per dtype."""
        by_dtype = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p)
        for ps in by_dtype.values():
            flat = collectives.sum_(
                torch.cat([p.grad.reshape(-1) for p in ps]), self.group)
            start = 0
            for p in ps:
                n = p.grad.numel()
                p.grad.copy_(flat[start:start + n].view_as(p.grad))
                start += n

    @torch.no_grad()
    def sum_losses(self, losses):
        """{name: loss} summed over the ranks (each rank's loss is its
        share of the global one)."""
        keys = sorted(losses)
        flat = collectives.sum_(torch.stack(
            [losses[k].detach().float() for k in keys]), self.group)
        return dict(zip(keys, flat.unbind()))


def _warn_unused_knobs(model):
    knobs = [k for k in ENCODER_KERNEL_KNOBS if model.tpu_cfg.get(k)]
    if knobs and tuple(knobs) not in _knob_warned:
        _knob_warned.add(tuple(knobs))
        log.warning("spatial parallelism runs the encoder's default "
                    "lowering: %s (K8-K10) do not apply", ", ".join(knobs))


def _rows_of(batch, rows):
    return {k: v[rows[0]:rows[1]] for k, v in batch.items()}


def make_sharded_train_step(model, tx, mesh, space_axis=None,
                            microbatch=None):
    """The train step of ``model.make_train_step`` over ``mesh``: ``step(
    global batch) -> global losses``, every rank called with the same
    batch.

    Args:
        tx: the optimizer over ``model.net``'s parameters.
        space_axis: ``"space"`` splits the pseudo-image's H over the space
            group (``ValueError`` where it does not divide H).
        microbatch: gradient accumulation over global chunks of that many
            items, each split over the data group (``ValueError`` where
            the data-axis size does not divide it).
    """
    if space_axis not in (None, "space"):
        raise ValueError(f"mesh has no {space_axis!r} axis: "
                         f"{Mesh.axis_names}")
    if microbatch is not None and int(microbatch) % mesh.n_data:
        raise ValueError(f"microbatch {microbatch} not divisible by the "
                         f"'data' axis size {mesh.n_data}")
    shard = Shard(mesh, model, spatial=space_axis is not None)
    return model.make_train_step(tx, microbatch=microbatch, shard=shard)


def _gather_preds(preds, mesh):
    """Every rank's detections of the data group, in batch order."""
    return {k: collectives.all_gather_cat(v, mesh.data_group)
            for k, v in preds.items()}


def _padded(batch, n_data):
    """The batch with empty items appended up to a multiple of
    ``n_data``, and its real size."""
    b = len(batch["points"])
    pad = -b % n_data
    if not pad:
        return batch, b
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v)
        out[k] = torch.cat([v, torch.zeros((pad, *v.shape[1:]),
                                           dtype=v.dtype, device=v.device)])
    return out, b


def make_sharded_eval_fn(model, mesh):
    """Data-parallel eval: ``run(global batch) -> (losses, preds)`` as
    ``model.make_eval_fn()`` gives them for the whole batch: the losses
    normalized by the global positive count and summed over the data
    group, the detections gathered over it."""
    shard = Shard(mesh, model)

    @torch.no_grad()
    def run(batch):
        local = _rows_of(batch, shard.batch_rows(len(batch["points"])))
        model.net.eval()
        outs = model._forward(local)
        losses = shard.sum_losses(model.loss(outs, local, shard=shard))
        return losses, _gather_preds(model._decode(outs, model.anchors),
                                     mesh)

    return run


def make_sharded_predict_fn(model, mesh):
    """Data-parallel predict: ``run(batch) -> predict(batch)`` of the whole
    batch on every rank, each rank predicting its rows (a batch that the
    data-axis size does not divide is padded with empty items, which are
    dropped again)."""

    def run(batch):
        padded, b = _padded(batch, mesh.n_data)
        local = _rows_of(padded, mesh.rows(len(padded["points"])))
        preds = _gather_preds(model.predict(local), mesh)
        return {k: v[:b] for k, v in preds.items()}

    return run


def make_spatial_predict_fn(model, mesh):
    """2-D parallel predict: the batch over the data group, the
    pseudo-image's H over the space group.

    Each rank voxelizes its items and runs the PFN on all their voxels,
    builds the grid rows of its slab only (K2; the other voxels go to the
    dump cell), and runs the encoder and the RPN on the slab with a
    one-row halo exchange before every 3x3x3 subm conv and 3x3 RPN conv;
    the down convs act on D and the head is 1x1, so they need none.  The
    gather encoder runs whole and each rank keeps its rows of the
    pseudo-image; the dense backbone takes a halo row before each 3x3
    conv, and its neck's transposed convs (kernel = stride) need none.
    The head outputs are gathered along H within the space group and each
    item is decoded (``_predict_single``); the detections are gathered
    over the data group.
    """
    shard = Shard(mesh, model, spatial=True)

    @torch.inference_mode()
    def run(batch):
        padded, b = _padded(batch, mesh.n_data)
        local = _rows_of(padded, shard.batch_rows(len(padded["points"])))
        model.net.eval()
        with shard.context(model.net):
            outs = model._forward(local)
        outs = [collectives.all_gather_cat(o, mesh.space_group, dim=1)
                for o in outs]
        preds = _gather_preds(model._decode(outs, model.anchors), mesh)
        return {k: v[:b] for k, v in preds.items()}

    return run
