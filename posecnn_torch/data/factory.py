"""Dataset factory: name -> dataset.

The port's counterpart of `posecnn_tpu/data/factory.py`, with the same
names (`list_imdbs()` is equal to the JAX package's):

  toy_train, toy_val        `data.toy.toy(split)`, seed 0: the frames'
                            draws depend on the seed and the index alone,
                            so `toy_val` holds `toy_train`'s frames
  lov_<split>               YCB-Video (`data.lov.lov`): train, val,
                            keyframe, trainval, debug, train_few, val_few
  linemod_<cls>_<split>     LINEMOD (`data.linemod.linemod`), 15 objects x
                            train, test, train_few, test_few
  ycb_<split>, lov_single_<cls>_<split>, ycb_single_<cls>_<split>,
  rgbd_scene_*, shapenet_scene_*, shapenet_single_*, gmu_scene_*, yumi_*,
  sym_*                     `data.variants`
  lov_syn_val_v4            the frozen frames of `data/lov_syn_val_v4/`
  lov_syn_val               the frozen frames of `data/lov_syn_val_v3/`
  lov_syn_train             frozen frames of `data/lov_syn_train_frozen/`
                            when its manifest is there, else 2000 frames
                            rendered over lov("train") (`SyntheticDataset`)

The three frozen sets (`data.lov_syn.LovSynVal`) take their object models
from lov("train") when a YCB-Video tree with its models is under the data
root (`data.lov.data_root()`), as the JAX package always does; without
one they keep the stand-in models, where the JAX package fails. The
datasets read files under the data root when they are built: a name
whose files are missing builds an empty dataset, or raises
FileNotFoundError naming the model file it needs.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List


def _toy(split: str):
    from posecnn_torch.data.toy import toy

    return toy(split)


def _ycb_models():
    """lov("train") where <data root>/LOV has its models, else None."""
    from posecnn_torch.data.lov import data_root, lov

    return lov("train") if os.path.isdir(os.path.join(data_root(), "LOV", "models")) else None


def _frozen(dirname: str, name: str):
    from posecnn_torch.data.lov_syn import DATA_DIR, LovSynVal

    return LovSynVal(os.path.join(DATA_DIR, dirname), name=name, base=_ycb_models())


def _lov_syn_train():
    from posecnn_torch.data.lov import lov
    from posecnn_torch.data.lov_syn import DATA_DIR
    from posecnn_torch.data.synthetic import SyntheticDataset

    if os.path.exists(os.path.join(DATA_DIR, "lov_syn_train_frozen", "manifest.json")):
        return _frozen("lov_syn_train_frozen", "lov_syn_train")
    return SyntheticDataset(lov("train"), split="train", num_images=2000)


def _lov(split: str):
    from posecnn_torch.data.lov import lov

    return lov(split)


def _linemod(cls: str, split: str):
    from posecnn_torch.data.linemod import linemod

    return linemod(cls, split)


def _variant(kind: str, *args):
    from posecnn_torch.data import variants

    return getattr(variants, kind)(*args)


def _registry() -> Dict[str, Callable]:
    from posecnn_torch.data.linemod import LINEMOD_CLASSES
    from posecnn_torch.data.lov import YCB_CLASSES

    reg: Dict[str, Callable] = {
        "toy_train": lambda: _toy("train"),
        "toy_val": lambda: _toy("val"),
        "lov_syn_val_v4": lambda: _frozen("lov_syn_val_v4", "lov_syn_val_v4"),
        "lov_syn_val": lambda: _frozen("lov_syn_val_v3", "lov_syn_val"),
        "lov_syn_train": _lov_syn_train,
    }
    for split in ("train", "val", "keyframe", "trainval", "debug", "train_few", "val_few"):
        reg[f"lov_{split}"] = lambda s=split: _lov(s)
    for cls in LINEMOD_CLASSES[1:]:
        for split in ("train", "test", "train_few", "test_few"):
            reg[f"linemod_{cls}_{split}"] = lambda c=cls, s=split: _linemod(c, s)
    for split in ("train", "val", "trainval", "keyframe"):
        reg[f"ycb_{split}"] = lambda s=split: _variant("ycb", s)
    for scene in ("rgbd_scene", "shapenet_scene", "shapenet_single", "gmu_scene", "yumi", "sym"):
        for split in ("train", "val", "trainval"):
            reg[f"{scene}_{split}"] = lambda sc=scene, s=split: _variant(sc, s)
    for cls in YCB_CLASSES[1:]:
        for split in ("train", "val"):
            reg[f"lov_single_{cls}_{split}"] = lambda c=cls, s=split: _variant("lov_single", c, s)
            reg[f"ycb_single_{cls}_{split}"] = lambda c=cls, s=split: _variant("ycb_single", c, s)
    return reg


_DATASETS: Dict[str, Callable] = _registry()


def register(name: str, ctor: Callable) -> None:
    """Add (or replace) dataset `name`, made by `ctor()` (`factory.py:register`)."""
    _DATASETS[name] = ctor


def get_imdb(name: str):
    if name not in _DATASETS:
        raise KeyError(f"Unknown dataset: {name}. Known: {sorted(_DATASETS)}")
    return _DATASETS[name]()


def list_imdbs() -> List[str]:
    return sorted(_DATASETS)
