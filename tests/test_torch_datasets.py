"""The port's dataset loaders (`posecnn_torch/data/{lov,linemod,variants,
factory,lov_syn}.py`) against the JAX package's, which read with cv2.

Fixture trees in each dataset's layout are written once for the module
(`tests/torch_parity.py:write_lov_tree`, `write_linemod_tree`,
`write_scene_tree`) from the frozen frames of data/lov_syn_val_v4/, and
POSECNN_DATA points both packages at them. The two `list_imdbs()` are
equal; every registered name builds in both; for one name of each
constructor the classes, symmetry flags, extents, model points, roidb,
image count and frames are equal to JAX's; LINEMOD reads its model from
`.xyz`, ASCII `.ply` and binary `.ply`, and its index from both layouts;
`lov_syn_val` (the committed v3 frames) takes lov("train")'s models from
a tree as JAX's does, and `lov_syn_val_v4` keeps its stand-in models
without one. LINEMOD's 2-class PoseCNN goes through `core/convert.py`
both ways, as the 22-class one does.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest

from posecnn_tpu.data import factory as JF
from posecnn_tpu.data.linemod import linemod as JaxLinemod
from posecnn_tpu.data.lov import lov as JaxLov
from posecnn_tpu.data.synthetic import FrozenSyntheticDataset
from posecnn_tpu.models import posecnn as JP
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import make_model, params_to_numpy
from posecnn_torch.data import factory as F
from posecnn_torch.data.linemod import linemod
from posecnn_torch.data.lov_syn import DATA_DIR, object_models
from posecnn_torch.data.variants import _GenericScene
from tests.torch_parity import v4_frame, write_linemod_tree, write_lov_tree, write_scene_tree

SCENES = {cls.DIRNAME: len(cls.CLASSES) for cls in _GenericScene.__subclasses__()}
FRAME_FIELDS = ("color", "label", "depth", "cls_indexes", "poses", "center", "intrinsic_matrix")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A data root with a YCB-Video tree (16 frames, data_syn of 16), a
    LINEMOD tree for ape and a tree for each scene dataset."""
    root = str(tmp_path_factory.mktemp("data"))
    write_lov_tree(root)
    write_linemod_tree(root, frames=range(4))
    for dirname, n in SCENES.items():
        write_scene_tree(root, dirname, n, frames=range(3))
    return root


@pytest.fixture
def data_root(tree, monkeypatch):
    monkeypatch.setenv("POSECNN_DATA", tree)
    return tree


def assert_frames_equal(a, b, what=""):
    for k in FRAME_FIELDS:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), (what, k, x.dtype, y.dtype,
                                                                                   x.shape, y.shape)
    assert a.factor_depth == b.factor_depth and a.is_synthetic == b.is_synthetic, what


def assert_datasets_equal(a, b, frames=(0,)):
    """Metadata and frames of a JAX and a port dataset."""
    assert tuple(a.classes) == tuple(b.classes) and a.num_classes == b.num_classes and a.num_images == b.num_images
    for k in ("_symmetry", "_extents", "_points_all"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert len(a._points) == len(b._points)
    for x, y in zip(a._points, b._points):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    if hasattr(a, "gt_roidb"):
        assert a.roidb == b.roidb and a.image_index == b.image_index and a.name == b.name
    for i in frames:
        assert_frames_equal(a.load_frame(i), b.load_frame(i), f"{b.name} frame {i}")


def test_list_imdbs_equals_jax():
    assert F.list_imdbs() == JF.list_imdbs()
    assert len(F.list_imdbs()) == 178


def test_every_name_builds_on_the_trees(data_root):
    """Every registered name builds in both packages on the fixture trees,
    with the same class count and image count (the JAX package's
    SyntheticDataset and frozen sets need the tree's models too)."""
    for name in F.list_imdbs():
        a, b = JF.get_imdb(name), F.get_imdb(name)
        assert a.num_classes == b.num_classes and a.num_images == b.num_images, name
        assert tuple(a.classes) == tuple(b.classes), name


# one name of each constructor, with frames to compare
CASES = {
    "lov_train": (0, 7, 15), "lov_keyframe": (3,), "ycb_trainval": (), "ycb_keyframe": (1,),
    "lov_single_006_mustard_bottle_train": (0, 5), "ycb_single_024_bowl_train": (2,),
    "rgbd_scene_train": (0, 2), "shapenet_scene_val": (1,), "shapenet_single_trainval": (0,),
    "gmu_scene_train": (2,), "yumi_val": (0,), "sym_train": (1,), "linemod_ape_train": (0, 3),
    "linemod_ape_test": (1,), "linemod_cat_train": (), "toy_val": (3,), "lov_syn_train": (0,),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loader_matches_jax(data_root, name):
    """Classes, symmetry, extents, model points, roidb and frames equal to
    the JAX loader's (cv2 there) on the same tree."""
    assert_datasets_equal(JF.get_imdb(name), F.get_imdb(name), CASES[name])


def test_lov_reads_the_tree_as_written(data_root):
    """lov_train's frames are the v4 frames the tree was written from; the
    models are cut to the smallest count (class 21's 1003 points); a frame
    whose meta file holds one object gets its (3,4) pose as (3,4,1)."""
    d = F.get_imdb("lov_train")
    assert d.num_images == 16 and d._points_all.shape == (22, 1003, 3) and len(d._points[21]) == 1003
    assert len(d._points[1]) == 1023
    for i in (0, 9):
        f, ref = d.load_frame(i), v4_frame(i)
        assert f.color.dtype == np.uint8 and f.label.dtype == np.uint8 and f.depth.dtype == np.uint16
        for k in FRAME_FIELDS:
            assert np.array_equal(getattr(f, k), getattr(ref, k)), k
    lm = F.get_imdb("linemod_ape_train").load_frame(0)
    assert lm.poses.shape == (3, 4, 1) and lm.label.dtype == np.int32 and set(np.unique(lm.label)) == {0, 1}
    assert np.array_equal(lm.cls_indexes, [1.0])


@pytest.mark.parametrize("model", ["xyz", "ply_ascii", "ply_binary"])
@pytest.mark.parametrize("layout", ["indexes", "class_dir"])
def test_linemod_models_and_index_layouts(tmp_path, model, layout):
    """LINEMOD's points from .xyz, ASCII .ply or binary .ply, its frame list
    from indexes/<cls>_<split>.txt or <cls>/<split>.txt, equal to JAX's;
    the diameter thresholds (ape: 0.1 x 102.1 mm)."""
    root = write_linemod_tree(str(tmp_path), cls="ape", frames=range(2), model=model, layout=layout)
    a, b = JaxLinemod("ape", "train", root), linemod("ape", "train", root)
    assert_datasets_equal(a, b, frames=(0, 1))
    assert b.num_images == 2 and b._points_all.shape == (2, 1023, 3)
    assert b.add_threshold() == a.add_threshold() and abs(b.add_threshold() - 0.010209865663) < 1e-12
    assert np.array_equal(a.diameters, b.diameters)


def test_lov_syn_val_takes_the_tree_models(data_root):
    """lov_syn_val serves the committed v3 frames (64, manifest-checked)
    with lov("train")'s models where a YCB-Video tree has them, equal to
    JAX's FrozenSyntheticDataset(lov("train"), v3); lov_syn_val_v4 takes
    them too."""
    b = F.get_imdb("lov_syn_val")
    a = FrozenSyntheticDataset(JaxLov("train"), os.path.join(DATA_DIR, "lov_syn_val_v3"))
    assert b.name == "lov_syn_val" and b.num_images == 64
    assert_datasets_equal(a, b, frames=(0, 63))
    v4 = F.get_imdb("lov_syn_val_v4")
    assert np.array_equal(v4._points_all, b._points_all) and np.array_equal(v4._extents, b._extents)


def test_frozen_sets_keep_the_stand_in_models_without_a_tree(tmp_path, monkeypatch):
    """With no YCB-Video tree under the data root, lov_syn_val_v4 is what
    it was: the stand-in models (`object_models`), its frames the npz
    files (now marked synthetic, as JAX marks frozen frames); lov_train
    has no model files to read and raises."""
    monkeypatch.setenv("POSECNN_DATA", str(tmp_path))
    d = F.get_imdb("lov_syn_val_v4")
    points, symmetry, extents = object_models(22)
    assert d.name == "lov_syn_val_v4" and d.num_images == 256 and not hasattr(d, "base")
    assert np.array_equal(d._points_all, points) and np.array_equal(d._extents, extents)
    assert np.array_equal(d._symmetry, symmetry)
    f = d.load_frame(5)
    assert f.is_synthetic
    for k in FRAME_FIELDS:
        assert np.array_equal(getattr(f, k), getattr(v4_frame(5), k)), k
    assert F.get_imdb("lov_syn_val")._points_all.shape == (22, 1024, 3)
    with pytest.raises(FileNotFoundError, match="points.xyz"):
        F.get_imdb("lov_train")


def test_convert_carries_linemod_two_classes_both_ways():
    """linemod_ape_pose.yml's PoseCNN (2 classes, NUM_UNITS 64, full VGG16
    widths): JAX's parameters load into the port through core/convert.py
    and come back unchanged, as the 22-class ones do."""
    cfg = C.train_model_cfg(C.cfg_from_file(os.path.join(C.Config().ROOT_DIR, "experiments", "cfgs",
                                                          "linemod_ape_pose.yml")), 2)
    jcfg = JP.PoseCNNConfig(num_classes=2, num_units=cfg.num_units)
    params = jax.tree_util.tree_map(np.asarray, JP.init_posecnn_params(jax.random.PRNGKey(5), jcfg))
    model = make_model(cfg, params, "cpu")
    assert model.score.weight.shape == (2, 64, 1, 1) and model.vertex_pred.weight.shape[0] == 6
    back = params_to_numpy(model.state_dict())
    assert set(back) == set(params)
    for layer, leaves in params.items():
        for leaf, a in leaves.items():
            assert back[layer][leaf].shape == a.shape and np.array_equal(back[layer][leaf], a), (layer, leaf)
