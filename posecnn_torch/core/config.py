"""The experiment configuration of the port: the config tree, a `.yml`
reader, and what the CLIs build from a config.

The port's own copy of `posecnn_tpu/core/config.py`: the four dataclasses
(`TrainConfig`, `TestConfig`, `TPUConfig`, `Config`) with every default,
the strict merge (`_merge_into`, `_coerce`: unknown keys and type mismatches
raise `ConfigError`, with the same messages), `cfg_from_file`, `cfg_replace`
and `get_output_dir`. There is no global config: functions take and return a
`Config`.

`load_yaml` reads the subset of YAML that the shipped `experiments/cfgs/*.yml`
files use: nested block maps by indentation, `#` comments, plain and quoted
scalars resolved as PyYAML's YAML 1.1 resolver resolves them (so `1e-4`,
which has no dot, is a string), flow sequences of scalars and the
`!!python/tuple [..]` tag. Anything else (anchors, aliases, other tags,
block sequences, multi-line or block scalars, flow maps, timestamps,
document markers, tabs) raises `YamlError`. PyYAML is not needed.

The builders assemble what `tools/train_net.py:107-164, 396-414` and
`tools/test_net.py:129-144` build from a config: the model config for
training (`train_model_cfg`) or testing (`test_model_cfg`), the training
hyper-parameters (`train_hparams`), the minibatch settings
(`minibatch_cfg`), FCN-8s's hyper-parameters and minibatch settings
(`seg_settings`), the detection network's model config and
hyper-parameters (`det_model_cfg`, `det_hparams`) and the test settings
(`test_settings`). Each first calls
`check_supported`, which raises `NotImplementedError` naming the first key
whose setting the port does not run.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os.path as osp
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class TrainConfig:
    WEIGHT_REG: float = 0.0001
    SEGMENTATION: bool = True
    SINGLE_FRAME: bool = False
    TRAINABLE: bool = True
    VERTEX_REG_2D: bool = False
    VERTEX_REG_3D: bool = False
    LABEL_W: float = 1.0
    VERTEX_W: float = 5.0
    VERTEX_W_INSIDE: float = 10.0
    POSE_W: float = 1.0
    POSE_MARGIN: float = 0.01
    POSE_NORM_VALID: bool = False
    THRESHOLD_LABEL: float = 1.0
    VOTING_THRESHOLD: float = -1.0
    VISUALIZE: bool = False
    GAN: bool = False
    POSE_REG: bool = False
    MATCHING: bool = False

    SYNTHESIZE: bool = False
    SYN_ONLINE: bool = False
    SYN_WIDTH: int = 640
    SYN_HEIGHT: int = 480
    SYNROOT: str = "data/LOV/data_syn/"
    SYNITER: int = 0
    SYNNUM: int = 80000
    SYN_RATIO: int = 1
    SYN_CLASS_INDEX: int = 1
    SYN_TNEAR: float = 0.5
    SYN_TFAR: float = 2.0
    SYN_SAMPLE_OBJECT: bool = True
    SYN_SAMPLE_POSE: bool = False
    SYN_BACKGROUND_SPECIFIC: bool = False

    ADAPT: bool = False
    ADAPT_ROOT: str = ""
    ADAPT_NUM: int = 400
    ADAPT_RATIO: int = 1
    ADAPT_WEIGHT: float = 0.1

    OPTIMIZER: str = "MOMENTUM"
    GRAD_CLIP: float = 0.0
    LEARNING_RATE: float = 0.001
    MOMENTUM: float = 0.9
    GAMMA: float = 0.1
    STEPSIZE: int = 30000
    SYMSIZE: int = 0

    GRID_SIZE: int = 256
    SCALES_BASE: Tuple[float, ...] = (1.0,)

    CHROMATIC: bool = True
    ADD_NOISE: bool = False

    IMS_PER_BATCH: int = 2
    NUM_STEPS: int = 5
    NUM_UNITS: int = 64
    NUM_CLASSES: int = 10
    USE_FLIPPED: bool = True

    SNAPSHOT_ITERS: int = 10000
    SNAPSHOT_PREFIX: str = "caffenet_fast_rcnn"
    SNAPSHOT_INFIX: str = ""
    SNAPSHOT_FINAL: bool = True
    DISPLAY: int = 20

    USE_GT: bool = False
    BATCH_SIZE: int = 128
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.1

    HAS_RPN: bool = True
    RPN_POSITIVE_OVERLAP: float = 0.7
    RPN_NEGATIVE_OVERLAP: float = 0.3
    RPN_CLOBBER_POSITIVES: bool = False
    RPN_FG_FRACTION: float = 0.5
    RPN_BATCHSIZE: int = 256
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    RPN_POSITIVE_WEIGHT: float = -1.0
    BBOX_NORMALIZE_TARGETS: bool = True
    BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    BBOX_NORMALIZE_TARGETS_PRECOMPUTED: bool = True
    BBOX_NORMALIZE_MEANS: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORMALIZE_STDS: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)


@dataclass
class TestConfig:
    SEGMENTATION: bool = True
    SINGLE_FRAME: bool = False
    VERTEX_REG_2D: bool = False
    VERTEX_REG_3D: bool = False
    VISUALIZE: bool = False
    RANSAC: bool = False
    REFERENCE_NMS_BUG: bool = False
    GAN: bool = False
    POSE_REG: bool = False
    POSE_REFINE: bool = False
    SYNTHETIC: bool = False
    VOTING_THRESHOLD: float = -1.0
    SCALES_BASE: Tuple[float, ...] = (1.0,)
    GRID_SIZE: int = 256
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 6000
    RPN_POST_NMS_TOP_N: int = 300
    BBOX_REG: bool = True
    NMS: float = 0.3


@dataclass
class TPUConfig:
    # read by nothing, as in the JAX package (whose CLIs build make_mesh(),
    # every device on the data axis): a multi-rank train_net runs at (N, 1)
    MESH_DATA: int = 0
    MESH_MODEL: int = 1
    COMPUTE_DTYPE: str = "bfloat16"
    MAX_ROI: int = 128
    MAX_DETECTIONS_TEST: int = 32
    MAX_GT: int = 24
    HOUGH_MAX_SAMPLES: int = 1024
    HOUGH_CENTER_STRIDE: int = 4
    HOUGH_CLASS_SLOTS: int = 8
    HOUGH_SAMPLER: str = "approx"
    HOUGH_PIXEL_STRIDE: int = 3
    HOUGH_SKIP_PIXELS: int = 1
    USE_CROP_POOL: bool = True
    HOUGH_FROM_GT: bool = False
    HOUGH_GT_MIX: float = 0.0
    CHECKPOINT_OPT_STATE: bool = True
    CHECKPOINT_FORMAT: str = "npz"
    DEVICE_TARGETS: bool = True
    ADD_NUM_POINTS: int = 1024
    DEVICE_BANK: bool = False
    BANK_REFRESH: bool = False
    BANK_REFRESH_CHUNK: int = 64
    BANK_REFRESH_THROTTLE: float = 0.0
    QUAT_AUX_W: float = 0.0
    VERTEX_Z_OBJ_NORM: bool = False
    PREFETCH: int = 4
    DEBUG_NANS: bool = False
    DEBUG_DISABLE_JIT: bool = False
    ICP_ITERS: int = 20
    ICP_PLANE_WEIGHT: float = 1.0
    DONATE_BATCH: bool = True


@dataclass
class Config:
    FLIP_X: bool = False
    INPUT: str = "RGBD"
    NETWORK: str = "VGG16"
    RIG: str = ""
    CAD: str = ""
    POSE: str = ""
    BACKGROUND: str = ""
    USE_GPU_NMS: bool = True
    ANCHOR_SCALES: Tuple[float, ...] = (8, 16, 32)
    ANCHOR_RATIOS: Tuple[float, ...] = (0.5, 1, 2)
    FEATURE_STRIDE: int = 16
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    TPU: TPUConfig = field(default_factory=TPUConfig)
    # BGR pixel means
    PIXEL_MEANS: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)
    RNG_SEED: int = 3
    EPS: float = 1e-14
    ROOT_DIR: str = osp.abspath(osp.join(osp.dirname(__file__), "..", ".."))
    EXP_DIR: str = "default"
    GPU_ID: int = 0

    def pixel_means(self) -> np.ndarray:
        return np.array(self.PIXEL_MEANS, dtype=np.float64).reshape(1, 1, 3)


class ConfigError(KeyError):
    pass


def _merge_into(dc: Any, overrides: dict, path: str = "") -> None:
    """Strict merge of a dict into a dataclass tree: every key must exist,
    value types must match (ints where floats are expected, and floats with
    no fraction where ints are), nested dicts recurse."""
    names = {f.name: f for f in dataclasses.fields(dc)}
    for key, value in overrides.items():
        if key not in names:
            raise ConfigError(f"{path}{key} is not a valid config key")
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise ConfigError(f"{path}{key}: expected a mapping")
            _merge_into(current, value, path=f"{path}{key}.")
            continue
        setattr(dc, key, _coerce(value, current, f"{path}{key}"))


def _coerce(value: Any, old: Any, where: str) -> Any:
    if old is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        raise ConfigError(f"{where}: expected bool, got {type(value).__name__}")
    if isinstance(old, float):
        if isinstance(value, (int, float)):
            return float(value)
        raise ConfigError(f"{where}: expected float, got {type(value).__name__}")
    if isinstance(old, int):
        if isinstance(value, bool):
            raise ConfigError(f"{where}: expected int, got bool")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        raise ConfigError(f"{where}: expected int, got {type(value).__name__}")
    if isinstance(old, str):
        if isinstance(value, str):
            return value
        raise ConfigError(f"{where}: expected str, got {type(value).__name__}")
    if isinstance(old, tuple):
        if isinstance(value, (list, tuple)):
            return tuple(value)
        raise ConfigError(f"{where}: expected sequence, got {type(value).__name__}")
    return value


# ---------------------------------------------------------------- the reader


class YamlError(ValueError):
    """The text is not in the YAML subset that `load_yaml` reads."""


# PyYAML's implicit resolvers for YAML 1.1 (yaml/resolver.py)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)
_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$"
)
_TRUE = {"yes", "true", "on"}
_TUPLE_TAG = "!!python/tuple"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f", "r": "\r",
            "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast) -> Any:
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _plain(text: str) -> Any:
    """A plain scalar, resolved and constructed as PyYAML's SafeLoader does."""
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _NULL.match(text):
        return None
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v.startswith("-") else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        if v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _TIMESTAMP.match(text):
        raise YamlError(f"timestamps are not read: {text!r}")
    if text in ("<<", "=") or text[0] in "!&*|>%@`[]{},#?":
        raise YamlError(f"not in the YAML subset: {text!r}")
    if text.startswith("- ") or text == "-" or ": " in text or text.endswith(":") or " #" in text:
        raise YamlError(f"not in the YAML subset: {text!r}")
    return text


def _quoted(text: str) -> Tuple[str, str]:
    """(the string of a quoted scalar at the start of `text`, the rest)."""
    q = text[0]
    out: List[str] = []
    i = 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = text[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise YamlError(f"bad escape in {text!r}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise YamlError(f"bad escape in {text!r}")
        out.append(c)
        i += 1
    raise YamlError(f"unterminated quoted scalar (multi-line scalars are not read): {text!r}")


def _strip_comment(rest: str, where: str) -> None:
    rest = rest.strip(" ")
    if rest and not rest.startswith("#"):
        raise YamlError(f"{where}: unexpected text after a value: {rest!r}")


def _scalar_or_comment(text: str) -> str:
    """A plain scalar's text: up to a ` #` comment, trailing blanks dropped."""
    m = re.search(r"\s#", text)
    return (text[:m.start()] if m else text).rstrip(" ")


def _flow_sequence(text: str, where: str) -> Tuple[list, str]:
    """([items], the rest) of a flow sequence of scalars at the start of text."""
    items: list = []
    i = 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise YamlError(f"{where}: unterminated flow sequence (multi-line sequences are not read)")
        c = text[i]
        if c == "]":
            return items, text[i + 1:]
        if c == ",":
            if expect_item:
                raise YamlError(f"{where}: empty item in a flow sequence")
            expect_item = True
            i += 1
            continue
        if not expect_item:
            raise YamlError(f"{where}: missing ',' in a flow sequence")
        if c in "'\"":
            s, rest = _quoted(text[i:])
            items.append(s)
            i = len(text) - len(rest)
        elif c in "[{":
            raise YamlError(f"{where}: nested flow collections are not read")
        else:
            m = re.match(r"[^,\]]*", text[i:])
            item = m.group(0).rstrip(" ")
            if "#" in item:
                raise YamlError(f"{where}: comment inside a flow sequence")
            items.append(_plain(item))
            i += m.end()
        expect_item = False


def _value(text: str, where: str) -> Any:
    """The value after `key:` on one line (non-empty)."""
    if text.startswith(_TUPLE_TAG + " ") or text == _TUPLE_TAG:
        rest = text[len(_TUPLE_TAG):].lstrip(" ")
        if not rest.startswith("["):
            raise YamlError(f"{where}: {_TUPLE_TAG} takes a flow sequence")
        items, rest = _flow_sequence(rest, where)
        _strip_comment(rest, where)
        return tuple(items)
    if text.startswith("["):
        items, rest = _flow_sequence(text, where)
        _strip_comment(rest, where)
        return items
    if text[0] in "'\"":
        s, rest = _quoted(text)
        _strip_comment(rest, where)
        return s
    return _plain(_scalar_or_comment(text))


_KEY_LINE = re.compile(r"^(?P<key>'[^']*'|\"[^\"]*\"|[^\s'\"#][^#]*?)\s*:(?:\s+(?P<value>.*)|)$")


def load_yaml(text: str) -> dict:
    """Parse the YAML subset of the shipped configs (see the module
    docstring) into nested dicts. An empty document gives {}."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        body = raw.rstrip(" \r")
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in body[: len(body) - len(stripped) + 1]:
            raise YamlError(f"{where}: tabs in indentation")
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise YamlError(f"{where}: document markers and directives are not read")
        m = _KEY_LINE.match(stripped)
        if m is None:
            raise YamlError(f"{where}: not a 'key: value' line: {stripped!r}")
        key_text = m.group("key")
        key = _quoted(key_text)[0] if key_text[0] in "'\"" else _plain(key_text)
        value = m.group("value")
        value = value.strip(" ") if value is not None else ""
        if value.startswith("#"):
            value = ""
        lines.append((len(body) - len(stripped), key, value, where))

    root: dict = {}
    # (indent of the map's keys, the map); a key with no value opens a child
    stack: List[Tuple[int, dict]] = [(lines[0][0] if lines else 0, root)]
    if lines and lines[0][0] != 0:
        raise YamlError(f"{lines[0][3]}: the top-level map is indented")
    pending: Optional[Tuple[dict, Any, int]] = None  # (parent, key, indent) of a key with no value yet
    for indent, key, value, where in lines:
        if pending is not None:
            parent, pkey, pindent = pending
            pending = None
            if indent > pindent:
                child: dict = {}
                parent[pkey] = child
                stack.append((indent, child))
            else:
                parent[pkey] = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise YamlError(f"{where}: bad indentation")
        target = stack[-1][1]
        if value == "":
            pending = (target, key, indent)
            target[key] = None
        else:
            target[key] = _value(value, where)
    return root


def read_yaml(filename: str) -> dict:
    with open(filename, "r") as f:
        return load_yaml(f.read())


def cfg_from_file(filename: str, target: Optional[Config] = None) -> Config:
    """Read a `.yml` config and merge it into `target` (a fresh `Config`
    when none is given); returns it."""
    target = Config() if target is None else target
    _merge_into(target, read_yaml(filename))
    return target


def cfg_replace(target: Config, **kwargs) -> Config:
    out = copy.deepcopy(target)
    _merge_into(out, kwargs)
    return out


def get_output_dir(config: Config, imdb_name: str, net_name: Optional[str] = None) -> str:
    """Artifact directory: <ROOT_DIR>/output/<EXP_DIR>/<imdb>[/<net>]."""
    path = osp.abspath(osp.join(config.ROOT_DIR, "output", config.EXP_DIR, imdb_name))
    return path if net_name is None else osp.join(path, net_name)


# -------------------------------------------------------------- the builders


# the networks the port runs: PoseCNN, its all-scale variant, FCN-8s,
# ResNet-50 and the detection network (`models/factory.py`); VGG16GAN has
# no branch in the JAX CLIs, which train and score it as PoseCNN
# (`models/gan.py` is reached through the factory alone). The JAX config
# has no RESNET50 value either: `--network resnet50` is its route there
NETWORKS = ("VGG16", "VGG16FULL", "VGG16GAN", "FCN8VGG", "RESNET50", "VGG16DET")


def pick_network(network: Optional[str], flag: str) -> str:
    """The factory name of the network a CLI builds from the config's
    NETWORK (None without a config) and its --network flag, with the JAX
    CLIs' precedence (`tools/train_net.py:83-96`, `tools/test_net.py:
    61-109`): VGG16DET by either first, then ResNet-50 by either (under an
    FCN8VGG config too), then FCN-8s, then VGG16FULL; otherwise PoseCNN,
    `vgg16_convs`, whatever the flag names (`vgg16`, `vgg16_3d`,
    `vgg16_gan` and `dcgan` too: the JAX CLIs branch on those four names
    alone). The run directory keeps the flag's name (`train_net.
    run_dir_name`), as JAX's `get_output_dir(imdb, net_name)` does."""
    if network == "VGG16DET" or flag == "vgg16_det":
        return "vgg16_det"
    if network == "RESNET50" or flag == "resnet50":
        return "resnet50"
    if network == "FCN8VGG" or flag == "fcn8_vgg":
        return "fcn8_vgg"
    if network == "VGG16FULL" or flag == "vgg16_full":
        return "vgg16_full"
    return "vgg16_convs"


def unsupported(cfg: Config, train: bool = True) -> List[str]:
    """The settings of `cfg` that the port does not run, as 'KEY: value'
    (training settings only with `train`)."""
    T, S, P = cfg.TRAIN, cfg.TEST, cfg.TPU
    rules = [
        ("NETWORK", cfg.NETWORK, cfg.NETWORK not in NETWORKS),
        ("TPU.CHECKPOINT_FORMAT", P.CHECKPOINT_FORMAT, P.CHECKPOINT_FORMAT not in ("npz", "orbax")),
        ("TPU.HOUGH_SAMPLER", P.HOUGH_SAMPLER, P.HOUGH_SAMPLER not in ("approx", "exact")),
    ]
    if train:
        rules += [
            # JAX's step reads a domain_score that vgg16_full never returns
            ("TRAIN.ADAPT", T.ADAPT, T.ADAPT and cfg.NETWORK == "VGG16FULL"),
            # JAX's step hands vgg16_full gt_centers, which it does not take
            ("TPU.HOUGH_FROM_GT", P.HOUGH_FROM_GT, P.HOUGH_FROM_GT and cfg.NETWORK == "VGG16FULL"),
            ("TPU.HOUGH_GT_MIX", P.HOUGH_GT_MIX, P.HOUGH_GT_MIX > 0 and cfg.NETWORK == "VGG16FULL"),
            ("TRAIN.MATCHING", T.MATCHING, T.MATCHING),
            # a dense host batch has no gt_centers, which JAX's step reads
            # for Hough from the GT (KeyError)
            ("TPU.DEVICE_TARGETS", P.DEVICE_TARGETS,
             not P.DEVICE_TARGETS and not P.DEVICE_BANK and (P.HOUGH_FROM_GT or P.HOUGH_GT_MIX > 0)
             and cfg.NETWORK not in ("FCN8VGG", "RESNET50", "VGG16DET")),
        ]
    else:
        rules += [
            # the JAX package's test_net on PoseCNN without the vertex head
            # raises KeyError: postprocess_detections reads rois, which the
            # inference function returns only with it (engine/test.py:87);
            # the 3D head decodes its own rois by RANSAC (:351-377);
            # VGG16GAN is scored as PoseCNN there
            ("TEST.VERTEX_REG_2D", S.VERTEX_REG_2D,
             cfg.NETWORK in ("VGG16", "VGG16GAN") and not S.VERTEX_REG_2D and not S.VERTEX_REG_3D),
        ]
    return [f"{k}: {v!r}" for k, v, bad in rules if bad]


def check_supported(cfg: Config, train: bool = True) -> None:
    """NotImplementedError naming the settings the port does not run; for
    training with TPU.CHECKPOINT_FORMAT orbax, ImportError naming
    tensorstore where it is not installed."""
    bad = unsupported(cfg, train)
    if bad:
        raise NotImplementedError(f"not ported yet: {bad[0]}" + (f" (and {', '.join(bad[1:])})" if bad[1:] else ""))
    if train and cfg.TPU.CHECKPOINT_FORMAT == "orbax":
        from posecnn_torch.core.checkpoint import tensorstore

        tensorstore()


def train_model_cfg(cfg: Config, num_classes: int):
    """The training `PoseCNNConfig` of `tools/train_net.py:107-128`, for
    VGG16 PoseCNN and VGG16FULL alike (the network is NETWORK's: VGG16FULL
    is `models.posecnn_full`, VGG16GAN PoseCNN)."""
    from posecnn_torch.config import PoseCNNConfig

    check_supported(cfg, train=True)
    T, P = cfg.TRAIN, cfg.TPU
    return PoseCNNConfig(
        num_classes=num_classes,
        num_units=T.NUM_UNITS,
        input_format=cfg.INPUT,
        vertex_reg=T.VERTEX_REG_2D or T.VERTEX_REG_3D,
        vertex_reg_3d=T.VERTEX_REG_3D,
        pose_reg=T.POSE_REG and not T.VERTEX_REG_3D,
        adaptation=T.ADAPT,
        threshold_label=T.THRESHOLD_LABEL,
        vote_threshold=T.VOTING_THRESHOLD,
        is_train=True,
        keep_prob=0.5,
        hough_class_slots=P.HOUGH_CLASS_SLOTS,
        hough_max_samples=P.HOUGH_MAX_SAMPLES,
        hough_center_stride=P.HOUGH_CENTER_STRIDE,
        hough_sampler=P.HOUGH_SAMPLER,
        hough_pixel_stride=P.HOUGH_PIXEL_STRIDE,
        skip_pixels=P.HOUGH_SKIP_PIXELS,
        use_crop_pool=P.USE_CROP_POOL,
        hough_from_gt=P.HOUGH_FROM_GT,
        hough_gt_mix=P.HOUGH_GT_MIX,
    )


def test_model_cfg(cfg: Config, num_classes: int):
    """The evaluation `PoseCNNConfig` of `tools/test_net.py:129-144`: the
    TEST section's heads, for VGG16 PoseCNN and VGG16FULL alike. The input format keeps PoseCNNConfig's default,
    COLOR, whatever INPUT says, as it does there: a DEPTH, NORMAL or RGBD
    snapshot is scored on colour frames."""
    from posecnn_torch.config import PoseCNNConfig

    check_supported(cfg, train=False)
    S, P = cfg.TEST, cfg.TPU
    return PoseCNNConfig(
        num_classes=num_classes,
        num_units=cfg.TRAIN.NUM_UNITS,
        vertex_reg=S.VERTEX_REG_2D or S.VERTEX_REG_3D,
        vertex_reg_3d=S.VERTEX_REG_3D,
        pose_reg=S.POSE_REG and not S.VERTEX_REG_3D,
        is_train=False,
        vote_threshold=S.VOTING_THRESHOLD,
        hough_class_slots=P.HOUGH_CLASS_SLOTS,
        hough_max_samples=P.HOUGH_MAX_SAMPLES,
        hough_center_stride=P.HOUGH_CENTER_STRIDE,
        hough_sampler=P.HOUGH_SAMPLER,
        hough_pixel_stride=P.HOUGH_PIXEL_STRIDE,
        skip_pixels=P.HOUGH_SKIP_PIXELS,
        use_crop_pool=P.USE_CROP_POOL,
    )


def online_model_cfg(cfg: Config):
    """The `PoseCNNConfig` of the serving tool (`tools/online.py:55-68`): the
    vertex and pose heads whatever TEST says, TRAIN.NUM_CLASSES and
    NUM_UNITS, TEST.VOTING_THRESHOLD (the multi-instance mode above 0) and
    the TPU section's Hough settings, as test_net's."""
    from posecnn_torch.config import PoseCNNConfig

    bad = [b for b in unsupported(cfg, train=False) if not b.startswith("TEST.VERTEX_REG_2D")]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
    P = cfg.TPU
    return PoseCNNConfig(
        num_classes=cfg.TRAIN.NUM_CLASSES,
        num_units=cfg.TRAIN.NUM_UNITS,
        vertex_reg=True,
        pose_reg=True,
        is_train=False,
        vote_threshold=cfg.TEST.VOTING_THRESHOLD,
        hough_class_slots=P.HOUGH_CLASS_SLOTS,
        hough_max_samples=P.HOUGH_MAX_SAMPLES,
        hough_center_stride=P.HOUGH_CENTER_STRIDE,
        hough_sampler=P.HOUGH_SAMPLER,
        hough_pixel_stride=P.HOUGH_PIXEL_STRIDE,
        skip_pixels=P.HOUGH_SKIP_PIXELS,
        use_crop_pool=P.USE_CROP_POOL,
    )


def demo_model_cfg(cfg: Config):
    """The demo's `PoseCNNConfig` (`tools/demo.py:58-62`): 22 classes, 64
    units, the vertex and pose heads, the TPU section's class slots,
    samples and centre stride; every other setting at its default."""
    from posecnn_torch.config import PoseCNNConfig

    P = cfg.TPU
    return PoseCNNConfig(num_classes=22, num_units=64, vertex_reg=True, pose_reg=True, is_train=False,
                         hough_class_slots=P.HOUGH_CLASS_SLOTS, hough_max_samples=P.HOUGH_MAX_SAMPLES,
                         hough_center_stride=P.HOUGH_CENTER_STRIDE)


def det_model_cfg(cfg: Config, num_classes: int, train: bool = True):
    """The `DetConfig` of the detection network (NETWORK VGG16DET): for
    training `tools/train_net.py:455`'s, the defaults (pre-NMS 6000,
    post-NMS 300, NMS 0.7) whatever TRAIN.RPN_* say; for testing
    `tools/test_net.py:70-76`'s, TEST.RPN_NMS_THRESH, RPN_PRE_NMS_TOP_N and
    RPN_POST_NMS_TOP_N."""
    from posecnn_torch.models.detection import DetConfig

    check_supported(cfg, train=train)
    if train:
        return DetConfig(num_classes=num_classes, is_train=True)
    S = cfg.TEST
    return DetConfig(num_classes=num_classes, is_train=False, rpn_nms_thresh=S.RPN_NMS_THRESH,
                     rpn_pre_nms_top_n=S.RPN_PRE_NMS_TOP_N, rpn_post_nms_top_n=S.RPN_POST_NMS_TOP_N)


def det_hparams(cfg: Config):
    """The detection trainer's `TrainHParams` (`tools/train_net.py:456-460`):
    the solver's rates and decay, the L2 weight and POSE_W; no clipping
    whatever TRAIN.GRAD_CLIP says."""
    from posecnn_torch.engine.train import TrainHParams

    check_supported(cfg, train=True)
    T = cfg.TRAIN
    return TrainHParams(learning_rate=T.LEARNING_RATE, momentum=T.MOMENTUM, gamma=T.GAMMA, stepsize=T.STEPSIZE,
                        weight_reg=T.WEIGHT_REG, pose_w=T.POSE_W)


def train_hparams(cfg: Config):
    """The `TrainHParams` of `tools/train_net.py:129-144`."""
    from posecnn_torch.engine.train import TrainHParams

    check_supported(cfg, train=True)
    T, P = cfg.TRAIN, cfg.TPU
    return TrainHParams(
        learning_rate=T.LEARNING_RATE,
        momentum=T.MOMENTUM,
        gamma=T.GAMMA,
        stepsize=T.STEPSIZE,
        weight_reg=T.WEIGHT_REG,
        vertex_w=T.VERTEX_W,
        pose_w=T.POSE_W,
        adapt_weight=T.ADAPT_WEIGHT,
        clip_grad_norm=T.GRAD_CLIP,
        margin=T.POSE_MARGIN,
        pose_norm_valid=T.POSE_NORM_VALID,
        matching_w=1.0 if T.MATCHING else 0.0,
        quat_w=P.QUAT_AUX_W,
        vertex_z_obj_norm=P.VERTEX_Z_OBJ_NORM,
    )


def minibatch_cfg(cfg: Config, num_classes: int):
    """The `MinibatchConfig` of `tools/train_net.py:146-164`."""
    from posecnn_torch.data.minibatch import MinibatchConfig

    check_supported(cfg, train=True)
    T, P = cfg.TRAIN, cfg.TPU
    return MinibatchConfig(
        num_classes=num_classes,
        pixel_means=cfg.pixel_means(),
        scale=float(T.SCALES_BASE[0]),
        chromatic=T.CHROMATIC,
        add_noise=T.ADD_NOISE,
        vertex_reg=T.VERTEX_REG_2D or T.VERTEX_REG_3D,
        vertex_reg_3d=T.VERTEX_REG_3D,
        vertex_w_inside=T.VERTEX_W_INSIDE,
        max_gt=P.MAX_GT,
        device_targets=P.DEVICE_TARGETS,
        input_format=cfg.INPUT,
        gan=T.GAN,
    )


def seg_settings(cfg: Config, num_classes: int):
    """(TrainHParams, MinibatchConfig) of the segmentation networks'
    training (`tools/train_net.py:396-414`, `train_segmentation`): the
    solver's rates, decay, L2 weight and clipping; minibatches without the
    vertex targets, in the config's INPUT."""
    from posecnn_torch.data.minibatch import MinibatchConfig
    from posecnn_torch.engine.train import TrainHParams

    check_supported(cfg, train=True)
    T = cfg.TRAIN
    hp = TrainHParams(learning_rate=T.LEARNING_RATE, momentum=T.MOMENTUM, gamma=T.GAMMA, stepsize=T.STEPSIZE,
                      weight_reg=T.WEIGHT_REG, clip_grad_norm=T.GRAD_CLIP)
    mcfg = MinibatchConfig(num_classes=num_classes, pixel_means=cfg.pixel_means(), chromatic=T.CHROMATIC,
                           add_noise=T.ADD_NOISE, vertex_reg=False, device_targets=cfg.TPU.DEVICE_TARGETS,
                           input_format=cfg.INPUT)
    return hp, mcfg


def solver_settings(cfg: Config) -> Dict[str, Any]:
    """The Solver arguments of `tools/train_net.py:271-290`."""
    T = cfg.TRAIN
    return dict(snapshot_iters=T.SNAPSHOT_ITERS, snapshot_prefix=T.SNAPSHOT_PREFIX,
                snapshot_opt_state=cfg.TPU.CHECKPOINT_OPT_STATE, snapshot_final=T.SNAPSHOT_FINAL, display=T.DISPLAY,
                snapshot_format=cfg.TPU.CHECKPOINT_FORMAT)


def test_settings(cfg: Config) -> Dict[str, Any]:
    """The `engine.test.test_net` settings of a config: TEST.NMS,
    TEST.POSE_REFINE, TPU.ICP_PLANE_WEIGHT, TEST.REFERENCE_NMS_BUG and the
    first of TEST.SCALES_BASE (`im_scale`, tools/test_net.py:190)."""
    check_supported(cfg, train=False)
    return dict(nms_threshold=cfg.TEST.NMS, pose_refine=cfg.TEST.POSE_REFINE,
                icp_plane_weight=cfg.TPU.ICP_PLANE_WEIGHT, reference_nms_bug=cfg.TEST.REFERENCE_NMS_BUG,
                im_scale=float(cfg.TEST.SCALES_BASE[0]))
