"""The port's config reader and builders against the JAX package's.

`posecnn_torch.core.config` reads the shipped `.yml` files without PyYAML.
Each file of experiments/cfgs/ is one case: the port's `cfg_from_file` must
equal JAX's `cfg_fresh` field by field (values and types), and the port's
builders must either give what `tools/train_net.py:107-164` and
`tools/test_net.py:129-144` build from it, or raise NotImplementedError
naming a config key. The YAML reader is also held to PyYAML (with the JAX
package's `!!python/tuple` loader) on edge cases, and the strict merge to
JAX's `ConfigError`s.
"""

from __future__ import annotations

import dataclasses as dc
import glob
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posecnn_tpu.core import config as JC
from posecnn_tpu.data.minibatch import MinibatchConfig as JaxMB
from posecnn_tpu.engine.train import TrainHParams as JaxHP
from posecnn_tpu.models.posecnn import PoseCNNConfig as JaxCfg
from posecnn_torch.core import config as C
from posecnn_torch.data.lov_syn import LovSynVal
from tests.torch_parity import goldens

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CFG_FILES = sorted(os.path.basename(f) for f in glob.glob(os.path.join(ROOT, "experiments", "cfgs", "*.yml")))


def _same_tree(got, ref, path=""):
    """Field by field, with types: dataclass trees, tuples, scalars."""
    if dc.is_dataclass(ref):
        assert type(got).__name__ == type(ref).__name__, path
        names = [f.name for f in dc.fields(ref)]
        assert [f.name for f in dc.fields(got)] == names, path
        for n in names:
            _same_tree(getattr(got, n), getattr(ref, n), f"{path}{n}.")
        return
    assert type(got) is type(ref), (path, got, ref)
    if isinstance(ref, tuple):
        assert len(got) == len(ref), path
        for a, b in zip(got, ref):
            _same_tree(a, b, path)
    else:
        assert got == ref, (path, got, ref)


def jax_train_objects(c, num_classes: int):
    """(PoseCNNConfig, TrainHParams, MinibatchConfig) of the JAX package,
    with the expressions of tools/train_net.py:107-164."""
    model_cfg = JaxCfg(
        num_classes=num_classes, num_units=c.TRAIN.NUM_UNITS, input_format=c.INPUT,
        vertex_reg=c.TRAIN.VERTEX_REG_2D or c.TRAIN.VERTEX_REG_3D, vertex_reg_3d=c.TRAIN.VERTEX_REG_3D,
        pose_reg=c.TRAIN.POSE_REG and not c.TRAIN.VERTEX_REG_3D, adaptation=c.TRAIN.ADAPT,
        threshold_label=c.TRAIN.THRESHOLD_LABEL, vote_threshold=c.TRAIN.VOTING_THRESHOLD, is_train=True,
        keep_prob=0.5, hough_class_slots=c.TPU.HOUGH_CLASS_SLOTS, hough_max_samples=c.TPU.HOUGH_MAX_SAMPLES,
        hough_center_stride=c.TPU.HOUGH_CENTER_STRIDE, hough_sampler=c.TPU.HOUGH_SAMPLER,
        hough_pixel_stride=c.TPU.HOUGH_PIXEL_STRIDE, skip_pixels=c.TPU.HOUGH_SKIP_PIXELS,
        use_crop_pool=c.TPU.USE_CROP_POOL, hough_from_gt=c.TPU.HOUGH_FROM_GT, hough_gt_mix=c.TPU.HOUGH_GT_MIX,
    )
    hp = JaxHP(
        learning_rate=c.TRAIN.LEARNING_RATE, momentum=c.TRAIN.MOMENTUM, gamma=c.TRAIN.GAMMA,
        stepsize=c.TRAIN.STEPSIZE, weight_reg=c.TRAIN.WEIGHT_REG, vertex_w=c.TRAIN.VERTEX_W, pose_w=c.TRAIN.POSE_W,
        adapt_weight=c.TRAIN.ADAPT_WEIGHT, clip_grad_norm=c.TRAIN.GRAD_CLIP, margin=c.TRAIN.POSE_MARGIN,
        pose_norm_valid=c.TRAIN.POSE_NORM_VALID, matching_w=1.0 if c.TRAIN.MATCHING else 0.0,
        quat_w=c.TPU.QUAT_AUX_W, vertex_z_obj_norm=c.TPU.VERTEX_Z_OBJ_NORM,
    )
    mcfg = JaxMB(
        num_classes=num_classes, pixel_means=c.pixel_means(), scale=float(c.TRAIN.SCALES_BASE[0]),
        chromatic=c.TRAIN.CHROMATIC, add_noise=c.TRAIN.ADD_NOISE, vertex_reg=model_cfg.vertex_reg,
        vertex_reg_3d=c.TRAIN.VERTEX_REG_3D, vertex_w_inside=c.TRAIN.VERTEX_W_INSIDE, max_gt=c.TPU.MAX_GT,
        device_targets=c.TPU.DEVICE_TARGETS, input_format=c.INPUT, gan=c.TRAIN.GAN,
    )
    return model_cfg, hp, mcfg


def jax_test_model_cfg(c, num_classes: int):
    """The model config of tools/test_net.py:129-144."""
    return JaxCfg(
        num_classes=num_classes, num_units=c.TRAIN.NUM_UNITS, vertex_reg=c.TEST.VERTEX_REG_2D or c.TEST.VERTEX_REG_3D,
        vertex_reg_3d=c.TEST.VERTEX_REG_3D, pose_reg=c.TEST.POSE_REG and not c.TEST.VERTEX_REG_3D, is_train=False,
        vote_threshold=c.TEST.VOTING_THRESHOLD, hough_class_slots=c.TPU.HOUGH_CLASS_SLOTS,
        hough_max_samples=c.TPU.HOUGH_MAX_SAMPLES, hough_center_stride=c.TPU.HOUGH_CENTER_STRIDE,
        hough_sampler=c.TPU.HOUGH_SAMPLER, hough_pixel_stride=c.TPU.HOUGH_PIXEL_STRIDE,
        skip_pixels=c.TPU.HOUGH_SKIP_PIXELS, use_crop_pool=c.TPU.USE_CROP_POOL,
    )


def assert_model_cfg_equal(got, ref):
    g, r = dc.asdict(got), dc.asdict(ref)
    assert set(g) == set(r)
    for k, v in r.items():
        if k == "compute_dtype":
            assert v == jnp.bfloat16 and g[k] == torch.bfloat16
        else:
            assert g[k] == v and type(g[k]) is type(v), (k, g[k], v)


def assert_fields_equal(got, ref):
    g, r = dc.asdict(got), dc.asdict(ref)
    assert set(g) == set(r)
    for k, v in r.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(g[k], v, err_msg=k)
        else:
            assert g[k] == v, (k, g[k], v)


def _config_keys(c, prefix="") -> set:
    out = set()
    for f in dc.fields(c):
        v = getattr(c, f.name)
        out |= _config_keys(v, f"{prefix}{f.name}.") if dc.is_dataclass(v) else {prefix + f.name}
    return out


def _refused_key(err: NotImplementedError) -> str:
    m = re.search(r"not ported yet: ([A-Z0-9_.]+): ", str(err))
    assert m is not None, str(err)
    return m.group(1)


@pytest.mark.parametrize("name", CFG_FILES)
def test_cfg_from_file_matches_jax(name):
    """The port's reader equals JAX's on the file, field by field; its
    builders give the JAX CLIs' objects or refuse a named key."""
    path = os.path.join(ROOT, "experiments", "cfgs", name)
    ref = JC.cfg_fresh(path)
    got = C.cfg_from_file(path)
    _same_tree(got, ref)
    keys = _config_keys(got)
    n = got.TRAIN.NUM_CLASSES
    try:
        objs = C.train_model_cfg(got, n), C.train_hparams(got), C.minibatch_cfg(got, n)
    except NotImplementedError as e:
        assert _refused_key(e) in keys and C.unsupported(got, train=True), str(e)
    else:
        assert not C.unsupported(got, train=True)
        want = jax_train_objects(ref, n)
        assert_model_cfg_equal(objs[0], want[0])
        assert dc.asdict(objs[1]) == dc.asdict(want[1])
        assert_fields_equal(objs[2], want[2])
    try:
        model_cfg, settings = C.test_model_cfg(got, n), C.test_settings(got)
    except NotImplementedError as e:
        assert _refused_key(e) in keys, str(e)
    else:
        assert_model_cfg_equal(model_cfg, jax_test_model_cfg(ref, n))
        assert settings == dict(nms_threshold=ref.TEST.NMS, pose_refine=ref.TEST.POSE_REFINE,
                                icp_plane_weight=ref.TPU.ICP_PLANE_WEIGHT,
                                reference_nms_bug=ref.TEST.REFERENCE_NMS_BUG,
                                im_scale=float(ref.TEST.SCALES_BASE[0]))


# the shipped training configs whose one unported setting was the host
# noise branch (TRAIN.ADD_NOISE without TPU.DEVICE_BANK)
HOST_NOISE_CFGS = (
    "linemod_ape_pose", "linemod_benchvise_pose", "linemod_camera_pose", "linemod_can_pose", "linemod_cat_pose",
    "linemod_color_2d", "linemod_driller_pose", "linemod_duck_pose", "linemod_eggbox_pose", "linemod_glue_pose",
    "linemod_holepuncher_pose", "linemod_iron_pose", "linemod_lamp_pose", "linemod_phone_pose",
    "lov_color_2d_pose", "lov_color_banana", "lov_color_bowl", "lov_color_gelatin_box", "lov_color_sugar_box",
    "lov_color_wood_block", "lov_single_color_pose", "lov_syn_color_2d", "lov_syn_color_2d_long",
    "lov_syn_pose_isolation", "lov_syn_tex_long", "lov_syn_tex_mix", "rgbd_scene_single_color",
    "shapenet_scene_single_color", "shapenet_single_single_color", "sym", "ycb_color_2d", "ycb_color_2d_pose",
    "ycb_color_cracker_box", "ycb_color_mustard_bottle", "ycb_color_potted_meat_can", "ycb_color_sugar_box",
    "ycb_color_tomato_soup_can", "yumi_color_2d",
)


def test_toy_pose_builds_and_the_refusals_cover_the_shipped_files():
    """toy_pose.yml, lov_syn_capstone.yml (with its bank refresh), the 10
    shipped files with TPU.BANK_REFRESH, the 38 with host noise, the 16 of
    the depth inputs and FCN8VGG, the 28 of the detection network and the
    3D head, and VGG16FULL, the adaptation cfg and VGG16GAN build for
    training; of the 105 shipped files all 105 build for training, 87 for
    testing and 87 for both (TRAIN.SYNTHESIZE's 4 files build since the
    synthesis mix is ported); every other file names the one unported
    setting of `unsupported` left: TEST.VERTEX_REG_2D False on PoseCNN (18,
    where JAX's test_net raises KeyError)."""
    toy = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml"))
    assert not C.unsupported(toy, train=True) and not C.unsupported(toy, train=False)
    cap = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "lov_syn_capstone.yml"))
    assert cap.TPU.BANK_REFRESH and C.unsupported(cap) == [] and not C.unsupported(cap, train=False)
    refused, refresh = set(), []
    train = test = both = 0
    for name in CFG_FILES:
        c = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", name))
        refused |= {r.split(":")[0] for r in C.unsupported(c, train=True) + C.unsupported(c, train=False)}
        if c.TPU.BANK_REFRESH:
            refresh.append(name)
            assert C.unsupported(c) == [], name
        tr, te = not C.unsupported(c, train=True), not C.unsupported(c, train=False)
        train, test, both = train + tr, test + te, both + (tr and te)
    assert len(CFG_FILES) == 105 and (train, test, both) == (105, 87, 87)
    assert len(refresh) == 10
    for name in HOST_NOISE_CFGS:
        c = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", name + ".yml"))
        assert c.TRAIN.ADD_NOISE and not c.TPU.DEVICE_BANK and C.unsupported(c) == [], name
    for name in INPUT_MODE_CFGS:
        c = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", name + ".yml"))
        assert not c.TPU.DEVICE_BANK and C.unsupported(c) == [], name
    for name in DET_3D_CFGS:
        c = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", name + ".yml"))
        assert C.unsupported(c) == [] and C.unsupported(c, train=False) == [], name
        assert (c.NETWORK == "VGG16DET") != (c.TRAIN.VERTEX_REG_3D and c.TEST.VERTEX_REG_3D), name
    for name in SLICE_J_CFGS:
        c = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", name + ".yml"))
        assert C.unsupported(c) == [], name
    assert refused == {"TEST.VERTEX_REG_2D"}
    assert not refused & {"TRAIN.SYNTHESIZE", "INPUT", "TPU.BANK_REFRESH", "TRAIN.ADD_NOISE", "TEST.POSE_REG", "TRAIN.VERTEX_REG_3D",
                          "TEST.VERTEX_REG_3D", "NETWORK", "TRAIN.ADAPT", "TRAIN.GAN", "TEST.GAN"}


# the shipped configs of VGG16FULL, the domain head (TRAIN.ADAPT) and
# VGG16GAN, which build for training
SLICE_J_CFGS = ("lov_color_2d_full", "lov_color_sugar_box_adapt", "shapenet_single_single_color_gan")


# the shipped configs of the detection network (NETWORK VGG16DET) and the
# 3D head (VERTEX_REG_3D), which build for training and testing
DET_3D_CFGS = tuple(f"linemod_{o}_{k}" for k in ("det", "3d") for o in (
    "ape", "benchvise", "camera", "can", "cat", "driller", "duck", "eggbox", "glue", "holepuncher", "iron", "lamp",
    "phone")) + ("lov_det", "lov_color_3d")


# the shipped training configs that the depth inputs (INPUT DEPTH, NORMAL,
# RGBD) and the segmentation network (NETWORK FCN8VGG) made buildable
INPUT_MODE_CFGS = (
    "lov_single_depth", "rgbd_scene_multi_depth", "rgbd_scene_multi_normal", "rgbd_scene_multi_rgbd",
    "rgbd_scene_single_color_fcn8", "rgbd_scene_single_depth", "rgbd_scene_single_depth_fcn8",
    "rgbd_scene_single_normal", "rgbd_scene_single_normal_fcn8", "rgbd_scene_single_rgbd",
    "shapenet_scene_multi_depth", "shapenet_scene_multi_normal", "shapenet_scene_multi_rgbd",
    "shapenet_scene_single_depth", "shapenet_scene_single_normal", "shapenet_scene_single_rgbd",
)


@pytest.mark.parametrize("name", INPUT_MODE_CFGS)
def test_input_mode_cfgs_build_a_model_a_minibatch_config_and_hparams(name):
    """Each of the 16: PoseCNN (its trunks, 2 for RGBD) or FCN-8s at narrow
    widths from the builders, the minibatch settings of its INPUT, and the
    hyper-parameters of the JAX CLI (`train_segmentation`'s for FCN8VGG)."""
    import dataclasses as dc

    from posecnn_torch.core.convert import init_params_numpy, make_model
    from posecnn_torch.models import fcn8 as F

    c = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", name + ".yml"))
    ref = JC.cfg_fresh(os.path.join(ROOT, "experiments", "cfgs", name + ".yml"))
    n = c.TRAIN.NUM_CLASSES
    if c.NETWORK == "FCN8VGG":
        hp, mcfg = C.seg_settings(c, n)
        model = F.make_fcn8(n, F.init_fcn8_params_numpy(0, n, trunk_scale=0.125, fc_dim=16), "cpu",
                            trunk_scale=0.125, fc_dim=16)
        assert model.score_fr.weight.shape[0] == n and not mcfg.vertex_reg
    else:
        model_cfg, hp, mcfg = C.train_model_cfg(c, n), C.train_hparams(c), C.minibatch_cfg(c, n)
        want = jax_train_objects(ref, n)
        assert_model_cfg_equal(model_cfg, want[0])
        assert dc.asdict(hp) == dc.asdict(want[1])
        narrow = dc.replace(model_cfg, trunk_scale=0.125, fc_dim=16)
        model = make_model(narrow, init_params_numpy(0, narrow), "cpu")
        assert hasattr(model, "trunk_p") == (c.INPUT == "RGBD") and model_cfg.input_format == c.INPUT
    assert mcfg.input_format == c.INPUT == ref.INPUT and mcfg.device_targets
    assert hp.learning_rate == ref.TRAIN.LEARNING_RATE and hp.weight_reg == ref.TRAIN.WEIGHT_REG


class _SmallFrames(LovSynVal):
    """The frozen frames of data/lov_syn_val_v4 at 64x80 (22 classes)."""

    def load_frame(self, i):
        return goldens().train_frames((f"data/lov_syn_val_v4/{i:06d}.npz",), depth=True)[0]


@pytest.mark.parametrize("name,missing", [("lov_color_2d_full", "upscore_conv4"),
                                          ("shapenet_single_single_color_gan", "rois")])
def test_jax_test_net_raises_on_vgg16_full_and_vgg16_gan(name, missing):
    """Two faults of the JAX package, called at narrow widths as its
    tools/test_net.py calls them: on VGG16FULL it draws PoseCNN's
    parameters (:145) and hands them to posecnn_full_forward, which reads
    the upscore_conv4 between its scales, which they lack (KeyError; next
    would come score_conv3); VGG16GAN falls through to PoseCNN
    without the vertex head (TEST.VERTEX_REG_2D False), whose rois
    postprocess_detections reads (KeyError 'rois', item 23). The port
    builds VGG16FULL's own parameters (tests/test_torch_full.py) and
    refuses VGG16GAN for testing."""
    import jax

    from posecnn_tpu.engine import test as JT
    from posecnn_tpu.models.posecnn import init_posecnn_params
    from posecnn_tpu.models.posecnn_full import posecnn_full_forward

    path = os.path.join(ROOT, "experiments", "cfgs", name + ".yml")
    ref, got = JC.cfg_fresh(path), C.cfg_from_file(path)
    data = _SmallFrames()
    jcfg = dc.replace(jax_test_model_cfg(ref, data.num_classes), trunk_scale=0.125, fc_dim=16,
                      compute_dtype=jnp.float32)
    params = init_posecnn_params(jax.random.PRNGKey(ref.RNG_SEED), jcfg)
    forward_fn = posecnn_full_forward if ref.NETWORK == "VGG16FULL" else None
    with pytest.raises(KeyError, match=missing):
        JT.test_net(params, jcfg, data, ref.pixel_means(), max_frames=1, forward_fn=forward_fn, log=None)
    if ref.NETWORK == "VGG16FULL":
        assert C.unsupported(got, train=False) == [] and not {"upscore_conv4", "score_conv3"} & set(params)
    else:
        assert C.unsupported(got, train=True) == [] and C.unsupported(got, train=False) == [
            "TEST.VERTEX_REG_2D: False"]


# texts the reader must read as PyYAML does
YAML_CASES = [
    "a: 1e-4", "a: .5", "a: -.5", "a: +.5", "a: -1", "a: +1", "a: 1.", "a: 3.0", "a: 1.0e+4", "a: 1.0e4",
    "a: 6.8523015e+5", "a: 685.230_15e+03", "a: 190:20:30.15", "a: 010", "a: 08", "a: 0x1F", "a: 0b101",
    "a: 0o7", "a: 1_000", "a: 1:30", "a: -1:00", "a: .inf", "a: -.Inf", "a: yes", "a: Off", "a: ~", "a: null",
    "a:", "a: 'it''s'", 'a: "x\\ty \\u00e9"', "a: 'x' # y", 'a: "q # r"', "a: foo bar # c", "a: foo#bar",
    "a: http://x/y", "a: [1, 'a', b, 2.5]", "a: []", "a: !!python/tuple [1.0]  # c", "a: !!python/tuple []",
    "a: !!python/tuple [0.5, 1, 2]", "1: x", "True: x", "a:\n  b: 1\n  c:\n    d: x\n  e: 2\nf: 3",
    "# top\na:\n  # inside\n  b: 1   # trailing\n\nc: 2\n", "a:\nb: 1", "a: 1\na: 2", "",
]


@pytest.mark.parametrize("text", YAML_CASES)
def test_yaml_reader_matches_pyyaml(text, tmp_path):
    p = tmp_path / "c.yml"
    p.write_text(text)
    ref = JC._yaml_load(str(p))
    got = C.load_yaml(text)
    assert got == ref and repr(got) == repr(ref), (got, ref)


YAML_REFUSED = [
    "a: 2001-12-14", "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x", "- 1", "a:\n  - 1",
    "a: {b: 1}", "---\na: 1", "a: [1, [2]]", "a: b: c", "a:\n\tb: 1", "a: 1\n  b: 2", "a: 'x", "a: [1, 2",
    "a: 'x' y", "  a: 1", "a: x\n  y", "<<: 1", "a: \"\\q\"",
]


@pytest.mark.parametrize("text", YAML_REFUSED)
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(C.YamlError):
        C.load_yaml(text)


CONFIG_ERRORS = [
    "FOO: 1", "TRAIN:\n  FOO: 1", "TRAIN: 3", "TRAIN:\n  IMS_PER_BATCH: True", "TRAIN:\n  IMS_PER_BATCH: 2.5",
    "TRAIN:\n  LEARNING_RATE: 1e-4", "TRAIN:\n  USE_FLIPPED: 1", "EXP_DIR:", "TEST:\n  SCALES_BASE: 1.0",
    "TPU:\n  HOUGH_SAMPLER: 3", "True: 1",
]


@pytest.mark.parametrize("text", CONFIG_ERRORS)
def test_config_errors_match_jax(text, tmp_path):
    """Unknown keys and type mismatches: the same ConfigError message."""
    p = tmp_path / "c.yml"
    p.write_text(text)
    with pytest.raises(JC.ConfigError) as ref:
        JC.cfg_fresh(str(p))
    with pytest.raises(C.ConfigError) as got:
        C.cfg_from_file(str(p))
    assert str(got.value) == str(ref.value)


def test_coercions_match_jax(tmp_path):
    """What the strict merge accepts: an int for a float, a whole float for
    an int, a list for a tuple; and cfg_replace, get_output_dir."""
    text = "TRAIN:\n  IMS_PER_BATCH: 2.0\n  LEARNING_RATE: 1\nTEST:\n  SCALES_BASE: [1.0, 2]\nEXP_DIR: e\n"
    p = tmp_path / "c.yml"
    p.write_text(text)
    ref, got = JC.cfg_fresh(str(p)), C.cfg_from_file(str(p))
    _same_tree(got, ref)
    assert got.TRAIN.IMS_PER_BATCH == 2 and got.TEST.SCALES_BASE == (1.0, 2)
    _same_tree(C.cfg_replace(got, TPU={"MAX_GT": 8}, RNG_SEED=5), JC.cfg_replace(ref, TPU={"MAX_GT": 8}, RNG_SEED=5))
    assert got.TPU.MAX_GT == 24  # cfg_replace copies
    assert C.get_output_dir(got, "toy_train", "vgg16_convs") == JC.get_output_dir("toy_train", "vgg16_convs", ref)
    assert C.get_output_dir(got, "toy_train") == JC.get_output_dir("toy_train", config=ref)


def test_flagship_settings_are_the_capstone_builders():
    """flagship_train_cfg, flagship_eval_cfg, FLAGSHIP_SOLVER and
    FLAGSHIP_TEST equal what the builders make from lov_syn_capstone.yml
    (whose bank refresh is a data setting: it changes none of them)."""
    from posecnn_torch.config import FLAGSHIP_SOLVER, FLAGSHIP_TEST, FLAGSHIP_TRAIN_BATCH, flagship_eval_cfg, \
        flagship_train_cfg

    cap = C.cfg_from_file(os.path.join(ROOT, "experiments", "cfgs", "lov_syn_capstone.yml"))
    assert cap.TPU.BANK_REFRESH
    model_cfg, hp = flagship_train_cfg()
    assert model_cfg == C.train_model_cfg(cap, 22) and hp == C.train_hparams(cap)
    assert flagship_eval_cfg() == C.test_model_cfg(cap, 22)
    assert FLAGSHIP_SOLVER == C.solver_settings(cap)
    assert {**FLAGSHIP_TEST, "reference_nms_bug": False, "im_scale": 1.0} == C.test_settings(cap)
    assert FLAGSHIP_TRAIN_BATCH == dict(batch_size=cap.TRAIN.IMS_PER_BATCH, max_gt=cap.TPU.MAX_GT,
                                        chromatic=cap.TRAIN.CHROMATIC, add_noise=cap.TRAIN.ADD_NOISE)
    assert cap.TPU.DEVICE_BANK and cap.INPUT == "COLOR"


def test_mesh_model_builds_as_in_jax(tmp_path):
    """TPU.MESH_MODEL: 2 (and MESH_DATA: 1) builds for training and testing,
    as in the JAX package, whose CLIs read neither: the configs built are
    toy_pose.yml's, and JAX's reader takes the file too."""
    toy = os.path.join(ROOT, "experiments", "cfgs", "toy_pose.yml")
    path = tmp_path / "toy_mesh_model.yml"
    path.write_text(open(toy).read() + "TPU:\n  MESH_DATA: 1\n  MESH_MODEL: 2\n")
    got, base = C.cfg_from_file(str(path)), C.cfg_from_file(toy)
    assert (got.TPU.MESH_DATA, got.TPU.MESH_MODEL) == (1, 2)
    assert C.unsupported(got, train=True) == [] and C.unsupported(got, train=False) == []
    assert C.train_model_cfg(got, 4) == C.train_model_cfg(base, 4)
    assert C.test_model_cfg(got, 4) == C.test_model_cfg(base, 4)
    assert C.train_hparams(got) == C.train_hparams(base) and C.solver_settings(got) == C.solver_settings(base)
    ref = JC.cfg_fresh()
    JC.cfg_from_file(str(path), ref)
    _same_tree(got, ref)
