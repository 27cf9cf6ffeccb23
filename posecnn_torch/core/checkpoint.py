"""Train-state snapshots in the JAX package's npz layout.

Port of `posecnn_tpu/core/checkpoint.py` (`save_checkpoint` with
fmt="npz", `_prune_old`, `_step_of`, `latest_checkpoint`,
`restore_checkpoint`). A snapshot is one flat .npz whose keys are the JAX
key paths of the train state (params, opt_state, step), so one file loads
in both packages:

  ['params']['conv1_1']['weights']                 HWIO, float32
  ['params']['upscore']['weights']                 the fixed bilinear filters
  ['step']                                         int32 scalar
  ['opt_state'][1][0].trace['conv1_1']['weights']  the momentum trace, with
                                                   clipping on (optax.chain of
                                                   the clip and sgd)
  ['opt_state'][0].trace['conv1_1']['weights']     the same, without clipping

A light snapshot (`include_opt_state=False`) has no opt_state; restoring
it keeps the target's trace (zero in a fresh state). The write is atomic:
the file is written as `<name>.tmp` and renamed. Orbax snapshots and TF1
`.ckpt` files are not read or written here.

Over a mesh of ranks (`parallel/mesh.py`), a parameter split over the model
axis, and its trace, are gathered whole and rank 0 writes the file in the
same layout (as JAX's npz writes its gathered global arrays), so a snapshot
loads in both packages at any mesh; on restore each rank keeps its rows.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from posecnn_torch.core.convert import params_from_numpy, params_to_numpy


def _trace_prefix(clipped: bool) -> str:
    """The key path of the momentum trace inside opt_state: the second link
    of `optax.chain(clip_by_global_norm, sgd)`, or sgd's own chain alone."""
    return "['opt_state'][1][0].trace" if clipped else "['opt_state'][0].trace"


def _flatten(prefix: str, nested: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {f"{prefix}['{layer}']['{leaf}']": a for layer, leaves in nested.items() for leaf, a in leaves.items()}


def _state_arrays(state, include_opt_state: bool) -> Dict[str, np.ndarray]:
    """A `engine.train.TrainState` -> {JAX key path: array} on the host,
    split parameters and their traces gathered whole (`mesh.gather_rows`:
    a collective over each one's model group)."""
    from posecnn_torch.parallel.mesh import gather_rows

    model, opt = state.model, state.optimizer
    arrays = _flatten("['params']", params_to_numpy({n: gather_rows(p) for n, p in model.named_parameters()}))
    arrays["['step']"] = np.asarray(state.step, np.int32)
    if include_opt_state:
        names = {id(p): n for n, p in model.named_parameters()}
        trace = params_to_numpy({names[id(p)]: gather_rows(p, t) for p, t in zip(opt.params, opt.trace)})
        for layer, leaves in trace.items():
            if layer.startswith("upscore"):  # fixed filters: never updated, zero trace
                leaves["weights"] = np.zeros_like(leaves["weights"])
        arrays.update(_flatten(_trace_prefix(opt.clip > 0), trace))
    return arrays


def save_checkpoint(
    directory: str,
    state,
    step: int,
    prefix: str = "posecnn",
    max_to_keep: int = 12,
    include_opt_state: bool = True,
    fmt: str = "npz",
    mesh=None,
) -> str:
    """Write `<prefix>_iter_<step>.npz` in `directory` and prune to the
    newest `max_to_keep`. Returns the path. Over a `mesh`, every rank calls
    it: all take part in the gather, rank 0 writes, and none returns before
    the file is in place."""
    if fmt != "npz":
        raise NotImplementedError(f"snapshot format {fmt!r} is not ported (npz only)")
    path = os.path.join(os.path.abspath(directory), f"{prefix}_iter_{step}.npz")
    arrays = _state_arrays(state, include_opt_state)
    if mesh is None or mesh.rank == 0:
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)  # atomic: readers never see a partial file
        _prune_old(directory, prefix, max_to_keep)
    if mesh is not None:
        mesh.barrier(next(state.model.parameters()).device)
    return path


def _prune_old(directory: str, prefix: str, max_to_keep: int) -> None:
    entries = []
    for name in os.listdir(directory):
        if name.endswith(".npz.tmp"):  # a write that was interrupted
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass
            continue
        if name.startswith(prefix + "_iter_"):
            try:
                entries.append((_step_of(name), name))
            except ValueError:
                continue
    entries.sort()
    for _, name in entries[:-max_to_keep]:
        try:
            os.remove(os.path.join(directory, name))
        except OSError:
            pass


def _step_of(name: str) -> int:
    stem = name[:-4] if name.endswith(".npz") else name
    return int(stem.rsplit("_", 1)[1])


def latest_checkpoint(directory: str, prefix: str = "posecnn") -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, path = -1, None
    for name in os.listdir(directory):
        if name.startswith(prefix + "_iter_") and not name.endswith(".tmp"):
            try:
                step = _step_of(name)
            except ValueError:
                continue
            if step > best:
                best, path = step, os.path.join(directory, name)
    return path


@torch.no_grad()
def restore_checkpoint(path: str, state):
    """Load a snapshot of either package into `state` (a
    `engine.train.TrainState`) in place: every parameter, the step counter
    and, where the file has one, the momentum trace; a parameter split over
    a model axis (`parallel.mesh.shard_model`) takes its rows of the whole
    one. Returns `state`."""
    from posecnn_torch.parallel.mesh import local_rows

    if not path.endswith(".npz"):
        raise NotImplementedError(f"{path}: only npz snapshots are read (orbax is not ported)")
    model, opt = state.model, state.optimizer
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    sd = params_from_numpy({k: v for k, v in arrays.items() if k.startswith("['params']")})
    params = dict(model.named_parameters())
    model.load_state_dict({k: local_rows(params[k], v) if k in params else v for k, v in sd.items()})
    state.step = int(arrays["['step']"])
    prefix = _trace_prefix(opt.clip > 0)
    if any(k.startswith(prefix) for k in arrays):
        names = {id(p): n for n, p in model.named_parameters()}
        # the upscore filters' trace is zero and has no parameter in the port
        trace = params_from_numpy({k[len(prefix):]: v for k, v in arrays.items()
                                   if k.startswith(prefix) and not k.startswith(prefix + "['upscore")})
        for p, t in zip(opt.params, opt.trace):
            t.copy_(local_rows(p, trace[names[id(p)]]))
    return state


def _leaf(data, layer: str, leaf: str):
    """(the key, the array or None) of a parameter leaf in an open npz, read
    under `['params']<key>` (a train-state snapshot) or `<key>` (a
    params-only export)."""
    key = f"['{layer}']['{leaf}']"
    found = [k for k in ("['params']" + key, key) if k in data.files]
    return key, (data[found[0]] if found else None)


def load_params_npz(path: str, params: Dict[str, Dict[str, np.ndarray]], log=None) -> Dict[str, Dict[str, np.ndarray]]:
    """Parameters from any of the JAX package's npz layouts, a train-state
    snapshot or a params-only export (`core/checkpoint.py:load_params_npz`,
    which its test_net uses for FCN8VGG): leaves the file lacks, and leaves
    of another shape, keep their values in `params`; keys the file has
    beyond `params` are not read."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    n = 0
    with np.load(path) as data:
        for layer, leaves in params.items():
            for leaf, a in leaves.items():
                key, arr = _leaf(data, layer, leaf)
                if arr is not None and arr.shape != a.shape:
                    if log:
                        log(f"shape mismatch, skipping {key}")
                    arr = None
                out.setdefault(layer, {})[leaf] = a if arr is None else arr.astype(a.dtype)
                n += arr is not None
    if log:
        log(f"restored {n}/{sum(len(v) for v in params.values())} tensors from {path}")
    return out


def restore_params(path: str, shapes: Dict[str, Dict[str, tuple]]) -> Dict[str, Dict[str, np.ndarray]]:
    """Every parameter of the model that `shapes` describes
    (`convert.param_shapes`), read from a snapshot of either package for
    test_net --model. Keys the model lacks (the second trunk of an RGBD
    snapshot) are not read. A leaf the file lacks, or has at another shape,
    raises ValueError naming it: the JAX package's test_net keeps the
    init value of a missing leaf, and loads a leaf of another shape and
    fails in the forward."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    missing = []
    with np.load(path) as data:
        for layer, leaves in shapes.items():
            for leaf, shape in leaves.items():
                key, arr = _leaf(data, layer, leaf)
                if arr is None:
                    missing.append(key)
                elif arr.shape != tuple(shape):
                    raise ValueError(f"{path}: {key} has shape {tuple(arr.shape)}, the model's is {tuple(shape)} "
                                     "(test_net builds the COLOR model whatever INPUT the snapshot was trained on)")
                else:
                    out.setdefault(layer, {})[leaf] = arr.astype(np.float32)
    if missing:
        n = sum(len(v) for v in shapes.values())
        raise ValueError(f"{path} lacks {len(missing)} of the model's {n} parameter tensors: {', '.join(missing)}")
    return out
