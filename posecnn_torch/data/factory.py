"""Dataset factory: name -> dataset, for the names the port can load.

The port's counterpart of `posecnn_tpu/data/factory.py`, for the datasets
that need no file from outside the repository:

  toy_train, toy_val  `data.toy.toy(split)` with the default seed 0, as the
                      JAX factory builds them (`data/factory.py:30-31`). The
                      frames' draws depend on the seed and the index alone,
                      so `toy_val` holds the same frames as `toy_train`.
  lov_syn_val_v4      the frozen frames of `data/lov_syn_val_v4/`
                      (`data.lov_syn.LovSynVal`).
"""

from __future__ import annotations

from typing import Callable, Dict, List


def _toy(split: str):
    from posecnn_torch.data.toy import toy

    return toy(split)


def _lov_syn_val_v4():
    from posecnn_torch.data.lov_syn import LovSynVal

    return LovSynVal()


_DATASETS: Dict[str, Callable] = {
    "toy_train": lambda: _toy("train"),
    "toy_val": lambda: _toy("val"),
    "lov_syn_val_v4": _lov_syn_val_v4,
}


def get_imdb(name: str):
    if name not in _DATASETS:
        raise KeyError(f"Unknown dataset: {name}. Known: {sorted(_DATASETS)}")
    return _DATASETS[name]()


def list_imdbs() -> List[str]:
    return sorted(_DATASETS)
