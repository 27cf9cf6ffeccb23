"""The rank grid and its sharding rules.

Port of `posecnn_tpu/parallel/mesh.py` onto `torch.distributed`. One
process (a rank) drives one device; the ranks form a (data, model) grid,
laid out as JAX's `reshape(data, model)` lays out its devices: rank
d * model + m sits at row d, column m.

  * axis "data": data parallelism. Each data row takes its slice of the
    global batch (`shard_batch`); the step divides its local sums by the
    counts all-reduced over the data group and sums the gradients over it,
    so it computes the one-process step's function on the global batch
    (`engine/train.py:make_train_step`).
  * axis "model": tensor parallelism. `param_sharding` (JAX's rule, on
    JAX's shapes) picks the large kernels whose output channels split over
    the model axis; `shard_model` keeps each rank's rows of them, and
    `models/layers.py` runs such a layer between `parallel/tp.py`'s f
    (identity forward, all-reduce backward) and g (all-gather forward,
    this rank's slice backward), so every model rank of a row computes the
    same loss.

A `Mesh` of one rank has no process group, and every collective on it is
the identity, so the same code runs without `torch.distributed`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

# minimum element count for a kernel to be channel-sharded over MODEL_AXIS
# (`mesh.py:34`); overridable, so that tiny test and dry-run graphs still
# shard something
TP_MIN_SIZE = 1 << 22

# the per-image blobs of the train step's batch: the keys of
# `posecnn_tpu/engine/train.py:make_train_step`'s batch_shardings
# (:358-365), which shard over the data axis; every other blob ('poses'
# rows, the GAN blobs the step does not read) is replicated
BATCH_KEYS = (
    "data", "data_p", "gt_label_2d", "vertex_targets", "vertex_weights", "vertex_targets3", "vertex_weights3",
    "meta_data", "gt_centers", "noise_sigma", "chroma_dhls",
)


def set_tp_min_size(n: int) -> None:
    global TP_MIN_SIZE
    TP_MIN_SIZE = int(n)


@dataclass(frozen=True)
class MeshSpec:
    data: int = 0  # 0 = all ranks over the model axis's size
    model: int = 1


class Mesh:
    """The (data, model) grid of `world` ranks and this rank's place in it.

    `data_group` holds the ranks of this rank's data column (same m: the
    group the gradients and the loss normalizers are summed over);
    `model_group` those of its model row (same d: the group of f and g).
    Both are None where the axis has one rank."""

    def __init__(self, data: int, model: int, rank: int = 0, data_group=None, model_group=None, world_group=None):
        self.data, self.model, self.rank = data, model, rank
        self.d, self.m = divmod(rank, model)
        self.data_group, self.model_group, self.world_group = data_group, model_group, world_group

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def world(self) -> int:
        return self.data * self.model

    def __repr__(self) -> str:
        return f"Mesh(data={self.data}, model={self.model}, rank={self.rank}: d={self.d}, m={self.m})"

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the data group (a copy, without gradient)."""
        from posecnn_torch.parallel.tp import all_reduce

        return all_reduce(x.detach().clone(), self.data_group)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the model group (a copy, without gradient)."""
        from posecnn_torch.parallel.tp import all_reduce

        return all_reduce(x.detach().clone(), self.model_group)

    def any(self, flag: bool, device) -> bool:
        """True on every rank when `flag` is true on any of them."""
        from posecnn_torch.parallel.tp import all_reduce

        if self.world_group is None:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        return bool(all_reduce(t, self.world_group, op="max").item() > 0)

    def gather_objects(self, obj) -> list:
        """Every rank's `obj`, in rank order, on every rank."""
        import torch.distributed as dist

        if self.world_group is None:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.world_group)
        return out

    def barrier(self, device) -> None:
        """Every rank waits for the others (an all-reduce of one value)."""
        self.any(False, device)


def make_mesh(spec: MeshSpec = MeshSpec(), world: Optional[int] = None) -> Mesh:
    """The mesh over every rank of the process group (`mesh.py:make_mesh`;
    one rank when `torch.distributed` is not initialized). Its size must be
    the world's: data * model == world. Every rank must call it, in the
    same order as any other `make_mesh`, since each creates its groups."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if live else 1
    model = max(spec.model, 1)
    data = spec.data if spec.data > 0 else world // model
    if data * model != world:
        raise ValueError(f"mesh ({data},{model}) does not cover the {world} ranks")
    if world == 1:
        return Mesh(1, 1)
    if not live:
        raise RuntimeError(f"a mesh of {world} ranks needs torch.distributed initialized (parallel.launch.initialize)")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(data, model)
    data_group = model_group = None
    # every rank creates every group, in one order (new_group is collective)
    for m in range(model):
        g = dist.new_group([int(r) for r in grid[:, m]]) if data > 1 else None
        if m == rank % model:
            data_group = g
    for d in range(data):
        g = dist.new_group([int(r) for r in grid[d, :]]) if model > 1 else None
        if d == rank // model:
            model_group = g
    return Mesh(data, model, rank, data_group, model_group, dist.group.WORLD)


def jax_shape(torch_shape: Sequence[int]) -> tuple:
    """A weight's shape in the JAX layout: OIHW -> HWIO, (out, in) -> (in,
    out); a bias as it is."""
    s = tuple(torch_shape)
    if len(s) == 4:
        return (s[2], s[3], s[1], s[0])
    return s[::-1] if len(s) == 2 else s


def param_sharding(mesh: Mesh, path: str, shape: Sequence[int]) -> bool:
    """JAX's parameter sharding rule (`mesh.py:param_sharding`), on the JAX
    path and shape of a leaf: True where its last (output-channel) axis
    splits over the model axis. The bilinear `upscore*` filters never do;
    a leaf does when the mesh has a model axis, it has two axes or more,
    TP_MIN_SIZE elements or more, and its last axis divides by the model
    axis's size. In the port's layouts that axis is dim 0 of an OIHW or
    (out, in) weight."""
    if "upscore" in str(path):
        return False
    shape = tuple(shape)
    return (mesh.model > 1 and len(shape) >= 2 and int(np.prod(shape)) >= TP_MIN_SIZE
            and shape[-1] % mesh.model == 0)


def sharded_names(model: torch.nn.Module, mesh: Mesh) -> list:
    """The port's names of the parameters `param_sharding` shards."""
    from posecnn_torch.core.convert import _layer_name

    out = []
    for name, p in model.named_parameters():
        path, leaf = name.rsplit(".", 1)
        key = f"['{_layer_name(path)}']['{'weights' if leaf == 'weight' else 'biases'}']"
        if param_sharding(mesh, key, jax_shape(p.shape)):
            out.append(name)
    return out


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep this rank's rows of every weight `param_sharding` shards (dim 0,
    the output channels: rows m*k .. (m+1)*k of the model axis's m-th
    rank), in place, and tag each with the mesh (`tp_mesh`), which routes
    its layer through f and g (`models/layers.py`). Biases stay whole and
    are added after g. Call it before `create_train_state`, whose momentum
    trace takes the parameters' shapes. Returns the model."""
    names = set(sharded_names(model, mesh))
    for name, p in model.named_parameters():
        if name in names:
            k = p.shape[0] // mesh.model
            p.data = p.data[mesh.m * k:(mesh.m + 1) * k].clone()
            p.tp_mesh = mesh
    return model


def tp_mesh(p: torch.Tensor) -> Optional[Mesh]:
    """The mesh a sharded parameter was split over, or None."""
    return getattr(p, "tp_mesh", None)


def gather_rows(p: torch.Tensor, x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole tensor of a sharded parameter `p` (or of `x`, laid out as
    its rows: its gradient, its momentum trace), gathered over the model
    group; `x` itself for a replicated one."""
    from posecnn_torch.parallel.tp import all_gather

    x = p if x is None else x
    mesh = tp_mesh(p)
    return x.detach() if mesh is None else all_gather(x.detach().contiguous(), mesh.model_group, 0)


def local_rows(p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """This rank's rows of `full` for the parameter `p` (`full` itself for
    a replicated one)."""
    mesh = tp_mesh(p)
    if mesh is None:
        return full
    k = p.shape[0]
    return full[mesh.m * k:(mesh.m + 1) * k]


def local_batch(mesh: Mesh, batch: Dict, keys: Sequence[str] = BATCH_KEYS) -> Dict:
    """The step's batch on this rank from its local shard (the blobs of
    `keys`) and the replicated blobs: the 'poses' rows, whose column 0 is
    the image's index in the global batch, get this rank's offset (d times
    the local batch) subtracted, so they index the local images; the rows
    of the other ranks' images fall outside them and match no detection,
    and the replicated rows stay whole, so Hough's batch-wide `gt_any` and
    the global max_gt cut hold as in the one-process step."""
    if mesh.data == 1 or "poses" not in batch:
        return dict(batch)
    lead = {len(batch[k]) for k in keys if k in batch}
    if len(lead) != 1:
        raise ValueError(f"the batch's per-image blobs have leading sizes {sorted(lead)}")
    out = dict(batch)
    poses = batch["poses"]
    poses = poses.copy() if isinstance(poses, np.ndarray) else poses.clone()
    poses[:, 0] -= mesh.d * lead.pop()
    out["poses"] = poses
    return out


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's part of a global host batch (`mesh.py:shard_batch`): the
    per-image blobs (`BATCH_KEYS`) split over the data axis, rows d*b ..
    (d+1)*b for b = B / data, everything else replicated (`local_batch`).
    Works on numpy arrays and tensors alike."""
    if mesh.data == 1:
        return dict(batch)
    out = dict(batch)
    for k in BATCH_KEYS:
        if k in batch:
            n = len(batch[k])
            if n % mesh.data:
                raise ValueError(f"batch blob {k!r}: {n} images do not split over {mesh.data} data ranks")
            b = n // mesh.data
            out[k] = batch[k][mesh.d * b:(mesh.d + 1) * b]
    return local_batch(mesh, out)


def shard_video_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's part of a global (T, B, ...) video batch, as JAX's video
    step shards it (`P(None, DATA_AXIS)`, `engine/train.py:774`): every
    blob split over its second axis, images d*b .. (d+1)*b for b = B /
    data. Works on numpy arrays and tensors alike."""
    if mesh.data == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        n = v.shape[1]
        if n % mesh.data:
            raise ValueError(f"video blob {k!r}: {n} images do not split over {mesh.data} data ranks")
        b = n // mesh.data
        out[k] = v[:, mesh.d * b:(mesh.d + 1) * b]
    return out
