"""Data layer: a shuffled stream of host minibatches, and a prefetch thread.

The port's own copy of `posecnn_tpu/data/layer.py:25-196`: `IndexStream`
(an endless shuffled index stream), `GtSynthesizeLayer` (`ims_per_batch`
frames an iteration through `data.minibatch.get_minibatch`, honouring the
flipped roidb entries of `imdb.append_flipped_images`; with TRAIN.ADAPT a
stream of adaptation frames, with TRAIN.SYNTHESIZE one of synthetic
frames pasted over `backgrounds`), `build_background_paths`,
`GtSingleDataLayer` and `prefetch`. One `RandomState(seed)` draws the
sources, the index permutations, the synthetic frames' picks, the
backgrounds and the chromatic deltas in the JAX package's order, so the
batches are bit-equal to its.

`prefetch` runs the batch assembly (numpy work only) on a daemon thread and
hands the batches over through a bounded queue; an exception in the thread
reaches the consumer. The copy to the device happens on the consumer's
thread (`engine.train.Solver`).
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from dataclasses import replace
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from posecnn_torch.data.minibatch import Frame, MinibatchConfig, get_minibatch


class IndexStream:
    """Endless shuffled index stream: a new permutation of range(n) from
    `rng` each time the last one is used up."""

    def __init__(self, n: int, rng: np.random.RandomState):
        self.n = n
        self.rng = rng
        self._perm = None
        self._cur = 0

    def next(self, count: int) -> np.ndarray:
        if self.n <= 0:
            raise ValueError("IndexStream over an empty dataset (0 images)")
        out = []
        while len(out) < count:
            if self._perm is None or self._cur >= self.n:
                self._perm = self.rng.permutation(np.arange(self.n))
                self._cur = 0
            take = min(count - len(out), self.n - self._cur)
            out.extend(self._perm[self._cur : self._cur + take])
            self._cur += take
        return np.asarray(out)


def build_background_paths(data_root: str = "data", input_format: str = "COLOR") -> List[str]:
    """The background bank of the synthetic frames, as file paths read when
    drawn (`posecnn_tpu/data/layer.py:build_background_paths`, the
    reference's `_build_background_images`): the images under SUN2012's
    data/Images and ObjectNet3D's data for COLOR, RGBD and NORMAL, under
    RGBD-Scenes for DEPTH (jpg, JPEG, jpeg and png, sorted). A root that is
    not there adds nothing."""
    if input_format in ("COLOR", "RGBD", "NORMAL"):
        roots = [os.path.join(data_root, "SUN2012", "data", "Images"), os.path.join(data_root, "ObjectNet3D", "data")]
    else:
        roots = [os.path.join(data_root, "RGBD-Scenes")]
    out: List[str] = []
    for root in roots:
        if not os.path.isdir(root):
            continue
        for ext in ("*.jpg", "*.JPEG", "*.jpeg", "*.png"):
            out.extend(glob.glob(os.path.join(root, "**", ext), recursive=True))
    return sorted(out)


class GtSynthesizeLayer:
    """Minibatches: `ims_per_batch` frames a batch from one source, drawn
    in the JAX package's order (`layer.py:107-144`). With `adapt`, first
    `rng.rand()` < adapt_ratio / (adapt_ratio + 1) makes a batch of
    adaptation frames (`adapt_frames(iteration, rng)`, marked
    `is_adaptation`); else, with `synthesize` and `syn_frames`,
    `rng.rand()` < syn_ratio / (syn_ratio + 1) makes one of synthetic
    frames (`syn_frames(iteration, rng)`, marked `is_synthetic`); else
    the next indices of the stream give real frames of `dataset`, mirrored
    where their roidb entry is flipped. Every batch's synthetic frames are
    pasted over `backgrounds` (arrays or PNG paths), where there are any.
    `sources` counts the batches made from each source."""

    def __init__(self, dataset, mcfg: MinibatchConfig, ims_per_batch: int = 2, synthesize: bool = False,
                 syn_ratio: int = 1, syn_frames: Optional[Callable[[int, np.random.RandomState], Frame]] = None,
                 adapt: bool = False, adapt_ratio: int = 1,
                 adapt_frames: Optional[Callable[[int, np.random.RandomState], Frame]] = None,
                 backgrounds: Sequence = (), seed: int = 3):
        if adapt and adapt_frames is None:
            raise ValueError("the adaptation stream needs adapt_frames")
        self.dataset = dataset
        self.mcfg = mcfg
        self.ims_per_batch = ims_per_batch
        self.synthesize = synthesize
        self.syn_ratio = syn_ratio
        self.syn_frames = syn_frames
        self.adapt = adapt
        self.adapt_ratio = adapt_ratio
        self.adapt_frames = adapt_frames
        self.backgrounds = list(backgrounds)
        self.rng = np.random.RandomState(seed)
        self.stream = IndexStream(dataset.num_images, self.rng)
        self._iter = 0
        self.sources = {"real": 0, "syn": 0, "adapt": 0}  # batches made from each

    def _source(self) -> str:
        if self.adapt and self.rng.rand() < self.adapt_ratio / (self.adapt_ratio + 1.0):
            return "adapt"
        if self.synthesize and self.syn_frames is not None and \
                self.rng.rand() < self.syn_ratio / (self.syn_ratio + 1.0):
            return "syn"
        return "real"

    def _batch(self, frames: List[Frame]) -> dict:
        d = self.dataset
        return get_minibatch(frames, self.mcfg, self.rng, extents=getattr(d, "_extents", None),
                             backgrounds=self.backgrounds, points=getattr(d, "_points_all", None),
                             symmetry=getattr(d, "_symmetry", None))

    def forward(self) -> dict:
        source = self._source()
        self.sources[source] += 1
        it, self._iter = self._iter, self._iter + 1
        if source == "adapt":
            return self._batch([replace(self.adapt_frames(it, self.rng), is_adaptation=True)
                                for _ in range(self.ims_per_batch)])
        if source == "syn":
            return self._batch([replace(self.syn_frames(it, self.rng), is_synthetic=True)
                                for _ in range(self.ims_per_batch)])
        frames: List[Frame] = []
        rdb = getattr(self.dataset, "_roidb", None)
        for i in self.stream.next(self.ims_per_batch):
            fr = self.dataset.load_frame(int(i))
            if rdb is not None and rdb[int(i)].get("flipped"):
                fr = replace(fr, flipped=True)  # a copy: a dataset may cache its frames
            if self.mcfg.vertex_reg_3d and fr.vertmap is None:
                # the JAX package's loaders set no vertmap either, and its
                # get_minibatch stops here with a TypeError
                raise ValueError(f"VERTEX_REG_3D training needs Frame.vertmap (per-pixel object coordinates): "
                                 f"frame {int(i)} of {getattr(self.dataset, 'name', 'the dataset')} has none")
            frames.append(fr)
        return self._batch(frames)

    def __iter__(self):
        while True:
            yield self.forward()


class GtSingleDataLayer(GtSynthesizeLayer):
    """The single-frame layer (`lib/gt_single_data_layer/layer.py`); the
    same stream of real frames."""


def prefetch(source: Iterator[dict], depth: int = 4) -> Iterator[dict]:
    """Items of `source`, made ahead on a daemon thread (at most `depth`
    waiting). An exception in the thread is raised to the consumer; when
    the consumer stops (closes the generator), the thread ends after the
    item it is making, and the close waits for it (a thread still making
    an item at the interpreter's exit can abort a process whose
    `torch.distributed` group it holds)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        # any failure must reach the consumer: a dead worker with no
        # sentinel would leave it waiting forever
        try:
            for item in source:
                if stop.is_set():
                    return
                if not put(item):
                    return
            put(None)
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer's side
            put(e)

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        if t is not threading.current_thread():
            t.join()
