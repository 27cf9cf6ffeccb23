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
the file is written as `<name>.tmp` and renamed.

fmt="orbax" (TPU.CHECKPOINT_FORMAT orbax) writes and reads the directory
`<prefix>_iter_<step>` that `orbax.checkpoint.StandardCheckpointer` writes
(`posecnn_tpu/core/checkpoint.py:67-72`, `:147-160`), through `tensorstore`
(imported at first use; orbax itself imports JAX): `_METADATA` (the tree:
each leaf's key path, dict keys and sequence indices, and the optimizer's
empty states as None leaves), `_CHECKPOINT_METADATA`, and one zarr array a
leaf, named by its key path joined with dots (`params.conv1_1.weights`,
`opt_state.1.0.trace.conv1_1.weights`, `step`), in an OCDBT key-value store
at the directory. It is written as `<name>.orbax-checkpoint-tmp` and
renamed. Without tensorstore, fmt="orbax" raises ImportError naming it.

The legacy weight readers (`load_vgg16_npy`, `load_tf1_checkpoint`,
`restore_partial`; `posecnn_tpu/core/checkpoint.py:195-271`) work on the
JAX-layout numpy dict {scope: {'weights', 'biases'}} (HWIO, fc (in, out))
that `core/convert.py` turns into the port's modules. The TF1 reader needs
no TensorFlow (`core/tf1_bundle.py`).

Over a mesh of ranks (`parallel/mesh.py`), a parameter split over the model
axis, and its trace, are gathered whole and rank 0 writes the file in the
same layout (as JAX's npz writes its gathered global arrays), so a snapshot
loads in both packages at any mesh; on restore each rank keeps its rows.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import time
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
    the file is in place. fmt "npz" or "orbax" (a directory)."""
    if fmt not in ("npz", "orbax"):
        raise ValueError(f"snapshot format {fmt!r}: npz or orbax")
    if fmt == "orbax":
        tensorstore()
    name = f"{prefix}_iter_{step}" + (".npz" if fmt == "npz" else "")
    path = os.path.join(os.path.abspath(directory), name)
    arrays = _state_arrays(state, include_opt_state)
    if mesh is None or mesh.rank == 0:
        os.makedirs(directory, exist_ok=True)
        if fmt == "npz":
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)  # atomic: readers never see a partial file
        else:
            write_orbax(path, arrays, clipped=state.optimizer.clip > 0)
        _prune_old(directory, prefix, max_to_keep)
    if mesh is not None:
        mesh.barrier(next(state.model.parameters()).device)
    return path


def _prune_old(directory: str, prefix: str, max_to_keep: int) -> None:
    entries = []
    for name in os.listdir(directory):
        if name.endswith(".orbax-checkpoint-tmp"):  # an interrupted orbax write
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
            continue
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
        full = os.path.join(directory, name)
        if os.path.isdir(full):
            shutil.rmtree(full, ignore_errors=True)
            continue
        try:
            os.remove(full)
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
    """Load a snapshot of either package, npz or orbax, into `state` (a
    `engine.train.TrainState`) in place: every parameter, the step counter
    and, where the file has one, the momentum trace; a parameter split over
    a model axis (`parallel.mesh.shard_model`) takes its rows of the whole
    one. Returns `state`."""
    from posecnn_torch.parallel.mesh import local_rows

    model, opt = state.model, state.optimizer
    with read_arrays(path) as data:
        arrays = {k: data[k] for k in data}
    dev = next(model.parameters()).device
    sd = params_from_numpy({k: v for k, v in arrays.items() if k.startswith("['params']")}, dev)
    params = dict(model.named_parameters())
    model.load_state_dict({k: local_rows(params[k], v) if k in params else v for k, v in sd.items()})
    state.step = int(arrays["['step']"])
    prefix = _trace_prefix(opt.clip > 0)
    if any(k.startswith(prefix) for k in arrays):
        names = {id(p): n for n, p in model.named_parameters()}
        # the upscore filters' trace is zero and has no parameter in the port
        trace = params_from_numpy({k[len(prefix):]: v for k, v in arrays.items()
                                   if k.startswith(prefix) and not k.startswith(prefix + "['upscore")}, dev)
        for p, t in zip(opt.params, opt.trace):
            t.copy_(local_rows(p, trace[names[id(p)]]))
    return state


def read_arrays(path: str):
    """The {JAX key path: array} mapping of a snapshot, as a context
    manager: an npz file read lazily, or an orbax directory read whole."""
    if os.path.isdir(path):
        return contextlib.nullcontext(read_orbax(path))
    return np.load(path)


def _leaf(data, layer: str, leaf: str):
    """(the key, the array or None) of a parameter leaf in a snapshot's
    arrays, read under `['params']<key>` (a train-state snapshot) or `<key>`
    (a params-only export)."""
    key = f"['{layer}']['{leaf}']"
    found = [k for k in ("['params']" + key, key) if k in data]
    return key, (data[found[0]] if found else None)


def load_params_npz(path: str, params: Dict[str, Dict[str, np.ndarray]], log=None) -> Dict[str, Dict[str, np.ndarray]]:
    """Parameters from any of the JAX package's npz layouts, a train-state
    snapshot or a params-only export (`core/checkpoint.py:load_params_npz`,
    which its test_net uses for FCN8VGG): leaves the file lacks, and leaves
    of another shape, keep their values in `params`; keys the file has
    beyond `params` are not read."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    n = 0
    with read_arrays(path) as data:
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
    with read_arrays(path) as data:
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


# ------------------------------------------------------------------ orbax

_PATH_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def tensorstore():
    """The tensorstore module, which fmt="orbax" reads and writes through;
    ImportError naming it where it is not installed."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError("TPU.CHECKPOINT_FORMAT orbax needs the tensorstore package, which is not installed "
                          "(npz snapshots need nothing)") from e
    return ts


def _key_parts(key: str):
    """A JAX key path (`['opt_state'][1][0].trace['conv1_1']['weights']`)
    -> orbax's key metadata: (name, key_type), 1 a sequence index, 2 a
    dict key or a named-tuple field."""
    return [(i, 1) if i else (a or d, 2) for d, i, a in _PATH_PART.findall(key)]


def _orbax_spec(ts, directory: str, name: str) -> dict:
    return {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{directory}/", "path": name + "/"}}


def write_orbax(path: str, arrays: Dict[str, np.ndarray], clipped: bool) -> None:
    """The train-state `arrays` ({JAX key path: array}) as the directory
    orbax's StandardCheckpointer writes. With an optimizer state, the
    optax chain's empty states are None leaves of the tree: the clip's and
    the sgd chain's second link with clipping, the second link without."""
    ts = tensorstore()
    tmp = path + ".orbax-checkpoint-tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    tree = {}
    writes = []
    for key, a in arrays.items():
        parts = _key_parts(key)
        names = tuple(n for n, _ in parts)
        a = np.asarray(a, order="C")  # (ascontiguousarray makes a scalar 1-d)
        tree[str(names)] = {"key_metadata": [{"key": n, "key_type": t} for n, t in parts],
                            "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False,
                                               "write_shape": list(a.shape)}}
        spec = {**_orbax_spec(ts, tmp, ".".join(names)),
                "metadata": {"shape": list(a.shape), "chunks": list(a.shape), "dtype": a.dtype.str,
                             "compressor": {"id": "zstd", "level": 1}}}
        writes.append(ts.open(spec, create=True).result().write(a))
    for w in writes:
        w.result()
    if any(k.startswith("['opt_state']") for k in arrays):
        empty = [("0",), ("1", "1")] if clipped else [("1",)]
        for idx in empty:
            tree[str(("opt_state",) + idx)] = {
                "key_metadata": [{"key": "opt_state", "key_type": 2}] + [{"key": i, "key_type": 1} for i in idx],
                "value_metadata": {"value_type": "None", "skip_deserialize": True}}
    # in tree order: orbax rebuilds each sequence by appending its indices
    order = sorted(tree, key=lambda k: [(m["key_type"], int(m["key"]) if m["key_type"] == 1 else m["key"])
                                        for m in tree[k]["key_metadata"]])
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": {k: tree[k] for k in order}, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    now = time.time_ns()
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                   "StandardCheckpointHandler", "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now, "custom_metadata": {}}, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def read_orbax(path: str) -> Dict[str, np.ndarray]:
    """{JAX key path: array} of an orbax StandardCheckpointer directory (the
    JAX package's, or `write_orbax`'s)."""
    ts = tensorstore()
    with open(os.path.join(path, "_METADATA")) as f:
        tree = json.load(f)["tree_metadata"]
    out, reads = {}, {}
    for entry in tree.values():
        if entry["value_metadata"].get("skip_deserialize"):
            continue
        parts = [(m["key"], m["key_type"]) for m in entry["key_metadata"]]
        key = "".join(f"[{n}]" if t == 1 else (f".{n}" if n == "trace" and i and parts[i - 1][1] == 1
                                                else f"['{n}']") for i, (n, t) in enumerate(parts))
        reads[key] = ts.open(_orbax_spec(ts, os.path.abspath(path), ".".join(n for n, _ in parts)),
                             open=True).result().read()
    for key, r in reads.items():
        out[key] = np.asarray(r.result())
    return out


# ------------------------------------------------------- legacy weight files

def load_vgg16_npy(path: str, params: Dict[str, Dict[str, np.ndarray]], dual_suffixes=("_p", "_d"),
                   log=None) -> Dict[str, Dict[str, np.ndarray]]:
    """A Caffe-exported vgg16.npy ({op: {'weights', 'biases'}}, pickled)
    merged into `params`: each op's leaves also into its `<op>_p` / `<op>_d`
    scopes where `params` has them (the reference's Network.load); a leaf of
    another shape is skipped (`posecnn_tpu/core/checkpoint.py:195-220`)."""
    data = np.load(path, allow_pickle=True, encoding="latin1").item()
    out = dict(params)
    for op_name, values in data.items():
        for scope in (op_name,) + tuple(op_name + s for s in dual_suffixes):
            if scope not in out:
                continue
            tgt = dict(out[scope])
            for param_name, value in values.items():
                if param_name not in tgt:
                    continue
                if tuple(tgt[param_name].shape) != tuple(value.shape):
                    if log:
                        log(f"skip {scope}/{param_name}: shape {value.shape} vs {tgt[param_name].shape}")
                    continue
                tgt[param_name] = np.asarray(value, np.float32)
                if log:
                    log(f"{scope}/{param_name} assigned")
            out[scope] = tgt
    return out


def load_tf1_checkpoint(path: str, params: Dict[str, Dict[str, np.ndarray]],
                        log=None) -> Dict[str, Dict[str, np.ndarray]]:
    """A TF1 checkpoint (the released PoseCNN model) merged into `params`,
    read without TensorFlow (`core/tf1_bundle.py`): `scope/leaf` variables
    by name and shape, skipping `global_step`, the bare `Variable` and the
    Momentum slots, as the reference's SolverWrapper.restore does
    (`posecnn_tpu/core/checkpoint.py:223-257`)."""
    from posecnn_torch.core.tf1_bundle import TF1Checkpoint

    reader = TF1Checkpoint(path)
    out = {k: dict(v) for k, v in params.items()}
    n = 0
    for var_name, shape in sorted(reader.shapes().items()):
        if var_name in ("global_step", "Variable") or "Momentum" in var_name:
            continue
        parts = var_name.split("/")
        if len(parts) != 2:
            continue
        scope, pname = parts
        if scope not in out or pname not in out[scope]:
            if log:
                log(f"skip {var_name}: not in target")
            continue
        if tuple(out[scope][pname].shape) != tuple(shape):
            if log:
                log(f"skip {var_name}: shape {tuple(shape)} vs {out[scope][pname].shape}")
            continue
        out[scope][pname] = reader.get_tensor(var_name).astype(np.float32)
        n += 1
        if log:
            log(f"{var_name} restored")
    if log:
        log(f"restored {n} tensors from {path}")
    return out


def restore_partial(source: Dict, target: Dict, log=None) -> Dict:
    """Name+shape-matched merge of one JAX-layout param dict into another
    (`posecnn_tpu/core/checkpoint.py:260-271`)."""
    out = {k: dict(v) for k, v in target.items()}
    for scope, values in source.items():
        if scope not in out:
            continue
        for pname, value in values.items():
            if pname in out[scope] and tuple(out[scope][pname].shape) == tuple(value.shape):
                out[scope][pname] = value
                if log:
                    log(f"{scope}/{pname} restored")
    return out


def load_weights(path: str, params: Dict[str, Dict[str, np.ndarray]], log=None) -> Dict[str, Dict[str, np.ndarray]]:
    """`params` with the weights of `path` merged in, by its kind as the JAX
    CLIs tell them apart (`tools/test_net.py:146-159`, `tools/online.py:
    69-81`): a vgg16.npy, an npz snapshot or params export (`load_params_npz`),
    an orbax directory, else a TF1 checkpoint prefix."""
    if path.endswith(".npy"):
        return load_vgg16_npy(path, params, log=log)
    if path.endswith(".npz") or os.path.isfile(os.path.join(path, "_METADATA")):
        return load_params_npz(path, params, log=log)
    return load_tf1_checkpoint(path, params, log=log)
