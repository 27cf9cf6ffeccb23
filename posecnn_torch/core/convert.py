"""Weights: JAX parameter layout <-> the port's state_dict, and seeded init.

The JAX package keeps parameters in a nested dict keyed by the reference's
scope names (`['conv1_1']['weights']`, HWIO; `['fc6']['weights']`, (in, out))
and snapshots them as one flat npz whose keys are jax key paths, prefixed
with `['params']` in a train-state snapshot
(`posecnn_tpu/core/checkpoint.py:_flatten_state`, `load_params_npz`). This
module reads that layout with numpy alone, so one snapshot loads in both
packages (`params_to_numpy` is the way back):

  conv weights  HWIO      -> OIHW      (`<name>.weight`; the trunk under
                                       `trunk.`, the RGBD input's second
                                       trunk, `conv*_p`, under `trunk_p.`)
  fc weights    (in, out) -> (out, in)
  biases        as they are
  upscore*      not parameters: checked against the bilinear formula on the
                way in, written from it on the way back

A weight's rank tells the two apart, so the same functions serve PoseCNN
(with its domain head, `fc9` and `domain_score`), VGG16FULL
(`models/posecnn_full.py`: `score_conv1`..`score_conv5` and their
`_vertex` twins), the detection network (`fc6` a fully connected layer,
`models/detection.py`), FCN-8s (`fc6` a 7x7 convolution,
`models/fcn8.py`) and ResNet-50 (`models/resnet50.py`: convolutions
without biases but for `conv1` and `score`, and the batch norms' `mean`
and `variance` leaves, which go across as they are; its `upscore` is the
32x32 filter at the score's width). The video models' recurrent cells
(`models/video.py`, `models/gru.py`) nest one level deeper:
`['gru2d']['Gates']['weights']` is `gru2d.Gates.weight` (OIHW), GRU3D's
`['gru3d']['Gates']['weights']` (in, out) is `gru3d.Gates.weight` (out,
in). The GAN models (`models/gan.py`) go through the same rules: a
transposed convolution's (k, k, c_o, c_i) kernel becomes (c_i, c_o, k, k),
PyTorch's `conv_transpose2d` layout; a batch norm's `scale`, `offset`,
`mean` and `variance` leaves go across as they are; DCGAN's int `size`
leaf is not a parameter (`gan.make_dcgan` reads it).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch

from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.models.backbone import VGG_CONV_DEFS, scaled_width, trunk_shapes
from posecnn_torch.models.layers import make_deconv_filter

_TRUNK = {name for name, *_ in VGG_CONV_DEFS}
_HEADS = {
    "score_conv5", "score_conv4", "score", "score_conv5_vertex", "score_conv4_vertex", "vertex_pred",
    "fc6", "fc7", "fc8",  # PoseCNN's pose head, FCN-8s's fc6 and fc7
    "fc9", "domain_score",  # PoseCNN's domain head (adaptation)
    # VGG16FULL's other scales (score_conv5 and 4 as above)
    "score_conv3", "score_conv2", "score_conv1",
    "score_conv3_vertex", "score_conv2_vertex", "score_conv1_vertex",
    "score_fr", "score_pool4", "score_pool3",  # FCN-8s
    # the detection network (fc6 and fc7 as above)
    "conv_rpn", "rpn_cls_score", "rpn_bbox_pred", "cls_score", "bbox_pred", "poses_pred_unnormalized",
}
# each score layer's bilinear upsampling filters (name, size), which the JAX
# package keeps as parameters at the score layer's width
_UPSCORES = {
    "score_conv5": (("upscore_conv5", 4), ("upscore", 16)),
    "score_conv5_vertex": (("upscore_conv5_vertex", 4), ("upscore_vertex", 16)),
    "score_fr": (("upscore2", 4), ("upscore4", 4), ("upscore32", 16)),
}
# VGG16FULL's x2 filters between its five scales, at num_units
_FULL_UPSCORES = tuple((f"upscore_conv{lvl}", 4) for lvl in "5432")
_KEY = re.compile(r"\['([^']*)'\]")
# ResNet-50's layers (`models/resnet50.py`; `score` is in _HEADS)
_RESNET = re.compile(r"conv1|bn_conv1|(res|bn)[2-5][a-f]_branch(1|2[abc])")
# the GAN models' layers (`models/gan.py`): DCGAN's generator and
# discriminator, the feature discriminator, vgg16_gan's patch discriminator
_GAN = re.compile(r"fc_z|conv[1-5]|bn[1-5]|deconv_[1-5]|bn[1-5]_deconv|conv_output|conv[1-5]_d|bn[2-5]_d|fc_d"
                  r"|conv[12]_g|fc_g|conv[1-5]_[1-3]_d|embed_d|score_d")
# a JAX leaf -> the port's parameter name, and back
_LEAVES = {"weights": "weight", "biases": "bias", "mean": "mean", "variance": "variance", "scale": "scale",
           "offset": "offset"}
_LEAVES_BACK = {v: k for k, v in _LEAVES.items()}
# the video models' recurrent cells: {cell: {sub-layer: {leaf: array}}}
_CELLS = {"gru2d", "gru3d"}


def _trunc_normal(rng: np.random.Generator, shape, stddev: float) -> np.ndarray:
    """stddev * N(0, 1) resampled outside [-2, 2] (the JAX package's
    truncated-normal init; the draws differ, the distribution does not)."""
    z = rng.standard_normal(shape, dtype=np.float32)
    flat = z.reshape(-1)
    bad = np.flatnonzero(np.abs(flat) > 2.0)  # row-major, the order a mask assigns in
    while bad.size:
        draws = rng.standard_normal(bad.size, dtype=np.float32)
        flat[bad] = draws
        bad = bad[np.abs(draws) > 2.0]  # only redrawn values can still be out
    z *= np.float32(stddev)
    return z


def init_conv(rng: np.random.Generator, k: int, ci: int, co: int, stddev=None) -> Dict[str, np.ndarray]:
    """A k x k convolution in the JAX layout: HWIO weights, He
    sqrt(2/fan_in) (or `stddev`) truncated at 2 sigma, zero biases."""
    std = math.sqrt(2.0 / (k * k * ci)) if stddev is None else stddev
    return {"weights": _trunc_normal(rng, (k, k, ci, co), std), "biases": np.zeros((co,), np.float32)}


def init_fc(rng: np.random.Generator, ci: int, co: int, stddev=None) -> Dict[str, np.ndarray]:
    """A fully connected layer in the JAX layout: (in, out) weights, He
    sqrt(2/fan_in) (or `stddev`) truncated at 2 sigma, zero biases."""
    std = math.sqrt(2.0 / ci) if stddev is None else stddev
    return {"weights": _trunc_normal(rng, (ci, co), std), "biases": np.zeros((co,), np.float32)}


def init_params_numpy(seed: int, cfg: PoseCNNConfig) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights in the JAX layout, with the shapes and init rules of
    `init_posecnn_params` (He sqrt(2/fan_in) truncated at 2 sigma; `score`
    0.01, `vertex_pred` and `fc8` 0.001, `domain_score` 0.01; zero biases;
    bilinear upscore; the `conv*_p` trunk and 2x wide
    `score_conv5`/`score_conv4` for RGBD; `fc9` and `domain_score` with
    `adaptation`)."""
    rng = np.random.default_rng(seed)
    C, U = cfg.num_classes, cfg.num_units
    c5 = scaled_width(512, cfg.trunk_scale)

    def conv(k, ci, co, stddev=None):
        return init_conv(rng, k, ci, co, stddev)

    def fc(ci, co, stddev=None):
        return init_fc(rng, ci, co, stddev)

    params = {name: conv(3, ci, co) for name, ci, co, _ in trunk_shapes(cfg.trunk_scale)}
    dual = cfg.input_format == "RGBD"
    if dual:
        params.update({name + "_p": conv(3, ci, co) for name, ci, co, _ in trunk_shapes(cfg.trunk_scale)})
    c5_label = 2 * c5 if dual else c5
    params["score_conv5"] = conv(1, c5_label, U)
    params["upscore_conv5"] = {"weights": make_deconv_filter(4, U)}
    params["score_conv4"] = conv(1, c5_label, U)
    params["upscore"] = {"weights": make_deconv_filter(16, U)}
    params["score"] = conv(1, U, C, stddev=0.01)
    if cfg.vertex_reg:
        params["score_conv5_vertex"] = conv(1, c5, 128)
        params["upscore_conv5_vertex"] = {"weights": make_deconv_filter(4, 128)}
        params["score_conv4_vertex"] = conv(1, c5, 128)
        params["upscore_vertex"] = {"weights": make_deconv_filter(16, 128)}
        params["vertex_pred"] = conv(1, 128, 3 * C, stddev=0.001)
        if cfg.pose_reg:
            params["fc6"] = fc(7 * 7 * c5, cfg.fc_dim)
            params["fc7"] = fc(cfg.fc_dim, cfg.fc_dim)
            params["fc8"] = fc(cfg.fc_dim, 4 * C, stddev=0.001)
            if cfg.adaptation:
                params["fc9"] = fc(7 * 7 * c5, 256)
                params["domain_score"] = fc(256, 2, stddev=0.01)
    return params


def _nest(flat: Mapping[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    """Flat jax key paths -> {layer: {leaf: array}}. A train-state snapshot
    keeps its parameters under `['params']`; bare keys are a params-only
    export."""
    parsed = {k: _KEY.findall(k) for k in flat}
    prefixed = any(p[:1] == ["params"] for p in parsed.values())
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for k, path in parsed.items():
        if prefixed:
            if path[:1] != ["params"]:
                continue  # optimizer state, step counter
            path = path[1:]
        elif path[:1] in (["opt_state"], ["step"]):
            continue
        if path == ["size"]:
            continue  # DCGAN's image side: an attribute of the model
        if len(path) == 3 and path[0] in _CELLS:
            out.setdefault(path[0], {}).setdefault(path[1], {})[path[2]] = np.asarray(flat[k])
            continue
        if len(path) != 2:
            raise ValueError(f"unexpected parameter key {k!r}")
        out.setdefault(path[0], {})[path[1]] = np.asarray(flat[k])
    return out


def _module_key(name: str) -> str:
    """A JAX layer name -> its module's path in the port."""
    if name in _TRUNK:
        return f"trunk.{name}"
    if name.endswith("_p") and name[:-2] in _TRUNK:
        return f"trunk_p.{name[:-2]}"
    if name in _HEADS or name in _CELLS or _RESNET.fullmatch(name) or _GAN.fullmatch(name):
        return name
    raise ValueError(f"parameter {name!r} belongs to a part of the network the port does not run")


def _layer_name(path: str) -> str:
    """The inverse of `_module_key` (a cell's sub-layer: the cell's name)."""
    if path.split(".")[0] in _CELLS:
        return path.split(".")[0]
    if path.startswith("trunk_p."):
        return path[len("trunk_p."):] + "_p"
    return path.split(".")[-1]


def params_from_numpy(params: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """JAX-layout parameters (nested `{layer: {'weights', 'biases'}}`, or
    `{'mean', 'variance'}` for a batch norm, or flat npz key paths) -> a
    state_dict for `models.posecnn.PoseCNN`, `models.fcn8.FCN8`,
    `models.resnet50.ResNet50` or a `models.gan` model, on the CPU, or on
    `device` (a card: each array is copied there as it is and transposed
    there). DCGAN's int `size`, the one top-level leaf that is not a
    layer, is left out; any other top-level leaf of a nested tree raises
    ValueError."""
    on_card = device is not None and torch.device(device).type != "cpu"
    if any(isinstance(v, Mapping) for v in params.values()):
        stray = [k for k, v in params.items() if not isinstance(v, Mapping) and k != "size"]
        if stray:
            raise ValueError(f"top-level leaves {stray} are not layers")
        nested = {k: v for k, v in params.items() if k != "size"}
    else:
        nested = _nest(params)
    sd: Dict[str, torch.Tensor] = {}
    for name, leaves in nested.items():
        if name.startswith("upscore"):
            w = np.asarray(leaves["weights"], dtype=np.float32)
            k, c = w.shape[0], w.shape[2]
            if w.shape != (k, k, c, c) or not np.array_equal(w, make_deconv_filter(k, c)):
                raise ValueError(f"{name}: not the fixed bilinear filter the port rebuilds")
            continue
        key = _module_key(name)
        layers = leaves.items() if name in _CELLS else [(None, leaves)]
        for sub, sub_leaves in layers:
            prefix = key if sub is None else f"{key}.{sub}"
            for leaf, a in sub_leaves.items():
                a = np.asarray(a, dtype=np.float32)
                if on_card:
                    t = torch.as_tensor(a).to(device)
                    if leaf == "weights":
                        t = t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()
                    sd[f"{prefix}.{_LEAVES[leaf]}"] = t.contiguous()
                    continue
                if leaf == "weights":
                    a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                sd[f"{prefix}.{_LEAVES[leaf]}"] = torch.tensor(np.ascontiguousarray(a))
    return sd


def _put(out: Dict, path: str, leaf: str, a) -> None:
    """out[layer][leaf] = a, or out[cell][sub-layer][leaf] for a cell's."""
    parts = path.split(".")
    node = out.setdefault(_layer_name(path), {})
    if parts[0] in _CELLS:
        node = node.setdefault(parts[1], {})
    node[_LEAVES_BACK[leaf]] = a


def params_to_numpy(named: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of `params_from_numpy`: tensors by module parameter name
    (a state_dict, or anything laid out like one, such as the momentum
    trace) -> the nested JAX layout, float32 on the host. OIHW -> HWIO,
    fc (out, in) -> (in, out); the `upscore*` filters, which the JAX package
    keeps as parameters, are written from the bilinear formula at the widths
    of the score layers that feed them (VGG16FULL's, recognised by its
    `score_conv1`, between its five scales; ResNet-50's, recognised by its
    `bn_conv1`, the 32x32 `upscore`)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in named.items():
        path, leaf = key.rsplit(".", 1)
        v = v.detach().float()
        if leaf == "weight":  # transposed where the tensor is (on a card: there)
            v = v.permute(2, 3, 1, 0) if v.dim() == 4 else v.t()
        _put(out, path, leaf, v.contiguous().cpu().numpy())
    if "bn_conv1" in out:  # ResNet-50: x16 from the score's classes
        out["upscore"] = {"weights": make_deconv_filter(32, out["score"]["weights"].shape[3])}
        return out
    if "score_conv1" in out:
        ups = {s: tuple((name + s[len("score_conv5"):], k) for name, k in _FULL_UPSCORES)
               for s in ("score_conv5", "score_conv5_vertex")}
    else:
        ups = _UPSCORES
    for score, names in ups.items():
        if score in out:
            c = out[score]["weights"].shape[3]
            for name, k in names:
                out[name] = {"weights": make_deconv_filter(k, c)}
    return out


def param_shapes(cfg, network: str = "vgg16_convs") -> Dict[str, Dict[str, tuple]]:
    """The JAX-layout shape of every parameter of `PoseCNN(cfg)`, of
    `PoseCNNFull(cfg)` for network "vgg16_full", of `VGG16Det(cfg)` for
    a `models.detection.DetConfig`, or of the video models for a
    `VideoConfig` ("vgg16") or `Video3DConfig` ("vgg16_3d") (the `upscore*`
    filters, which the port rebuilds, left out), read from a model on the
    meta device: no weights are drawn."""
    from posecnn_torch.models.detection import DetConfig, VGG16Det
    from posecnn_torch.models.posecnn import PoseCNN
    from posecnn_torch.models.posecnn_full import PoseCNNFull
    from posecnn_torch.models.video import Video3DConfig, Video3DNet, VideoConfig, VideoNet

    if isinstance(cfg, DetConfig):
        model = VGG16Det(cfg, device="meta")
    elif isinstance(cfg, (VideoConfig, Video3DConfig)):
        model = (Video3DNet if isinstance(cfg, Video3DConfig) else VideoNet)(cfg, device="meta")
    else:
        model = (PoseCNNFull if network == "vgg16_full" else PoseCNN)(cfg, device="meta")
    out: Dict[str, Dict[str, tuple]] = {}
    for key, v in model.state_dict().items():
        path, leaf = key.rsplit(".", 1)
        s = tuple(v.shape)
        if leaf == "weight":
            s = (s[2], s[3], s[1], s[0]) if len(s) == 4 else s[::-1]
        _put(out, path, leaf, s)
    return out


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """A JAX npz snapshot (train state or params-only export) -> state_dict."""
    with np.load(path) as data:
        return params_from_numpy({k: data[k] for k in data.files})


def make_model(cfg: PoseCNNConfig, params: Mapping, device) -> "torch.nn.Module":
    """`PoseCNN` on `device` holding JAX-layout `params` (nested or flat)."""
    from posecnn_torch.models.posecnn import PoseCNN

    model = PoseCNN(cfg, device=device)
    model.load_state_dict(params_from_numpy(params, device), strict=True)
    return model.eval()
