"""Continuous refresh of the training data bank held on the card.

The port of `posecnn_tpu/data/bank_refresh.py`. A frozen bank is a finite
dataset: over a long schedule every frame is sampled many times, and the
rotation and log-z heads memorize appearance instead of generalizing. The
reference never reuses a synthetic frame: its render thread streams a
fresh scene every iteration. This module streams fresh scenes into the
bank while the card steps:

  * `BankRefresher`: a daemon thread that renders scenes with the host
    rasterizer (`data.synthetic`) and packs them into bank-row chunks
    (`device_bank.pack_frames`). It touches no CUDA; ctypes and NumPy's
    loops release the GIL, so rendering overlaps the main thread's waits.
  * `splice`: a new bank with one chunk written at a row offset. The bank
    already handed out is not changed: the solver fetches the next item
    before it launches the current step, so an in-place write would land
    one step early (JAX's `dynamic_update_slice` also returns a new bank).
  * `refreshing_bank_iter`: the solver's data iterator. It yields the
    current bank every step and splices in a ready chunk before a yield,
    rotating the write window over the whole bank (`chunk_positions`).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from posecnn_torch.data.device_bank import pack_frames

# refresh frames draw from their own seed region, far from the train stream
# (seed0 0) and the val stream (seed0 10_000_000) of data/synthetic.py, so a
# refreshed bank never holds a val frame
REFRESH_SEED0 = 50_000_000


def refresh_synthesizer(imdb):
    """The synthesizer of the train dataset's render configuration: a
    `SyntheticDataset`'s own, else one built over the dataset (or its
    `base`) with the `render_params` of its manifest (the frozen frames'
    width, height, object counts, visibility gate and depth range); a
    manifest without them gets the `SyntheticDataset` defaults."""
    synth = getattr(imdb, "synth", None)
    if synth is not None:
        return synth
    from posecnn_torch.data.synthetic import build_ycb_synthesizer

    base = getattr(imdb, "base", imdb)
    params = dict(getattr(imdb, "manifest", {}).get(
        "render_params", {"width": 640, "height": 480, "max_objects": 5}))
    return build_ycb_synthesizer(base, **params)


class BankRefresher(threading.Thread):
    """Background producer of packed bank-row chunks.

    Frame i of the stream is rendered from seed `REFRESH_SEED0 + i`, i
    counting from `seed_offset` (the resume iteration), so the stream never
    repeats within a run and never meets the train or val seeds. With a
    `counter_path`, the counter after each chunk is written there (through
    a rename, so a reader finds a whole number) and a later refresher
    starts from the larger of it and `seed_offset`: a run killed before its
    steps advanced does not replay its seeds when resumed.

    `frames_rendered` and `render_s` (seconds inside rendering and packing,
    not in the throttle's sleeps or waits on a full queue) give its rate.
    """

    def __init__(self, synth, g_max: int, chunk_size: int = 64,
                 seed_offset: int = 0, max_ready: int = 2,
                 throttle_sec: float = 0.0, counter_path: Optional[str] = None):
        super().__init__(daemon=True, name="bank-refresher")
        self.synth = synth
        self.g_max = int(g_max)
        self.chunk_size = int(chunk_size)
        # renders contend with the train loop for the host's cores; the
        # throttle (a sleep after each frame) caps the render duty cycle
        self.throttle_sec = float(throttle_sec)
        self._counter = int(seed_offset)
        self.counter_path = counter_path
        if counter_path is not None and os.path.exists(counter_path):
            try:
                with open(counter_path) as fh:
                    self._counter = max(self._counter, int(fh.read().strip()))
            except (OSError, ValueError):
                pass
        self.seed_start = self._counter
        self._ready: "queue.Queue[Dict[str, np.ndarray]]" = queue.Queue(maxsize=max_ready)
        self._stop_evt = threading.Event()
        self.render_s = 0.0

    @property
    def frames_rendered(self) -> int:
        return self._counter - self.seed_start

    def _persist_counter(self):
        if self.counter_path is None:
            return
        tmp = self.counter_path + ".tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(str(self._counter))
            os.replace(tmp, self.counter_path)
        except OSError:
            pass

    def run(self):
        while not self._stop_evt.is_set():
            frames = []
            for _ in range(self.chunk_size):
                t0 = time.perf_counter()
                rng = np.random.RandomState(REFRESH_SEED0 + self._counter)
                self._counter += 1
                frames.append(self.synth.render_scene(rng))
                self.render_s += time.perf_counter() - t0
                if self._stop_evt.is_set():
                    return
                if self.throttle_sec > 0.0:
                    time.sleep(self.throttle_sec)
            t0 = time.perf_counter()
            chunk = pack_frames(frames, self.g_max)
            self.render_s += time.perf_counter() - t0
            self._persist_counter()
            while not self._stop_evt.is_set():
                try:
                    self._ready.put(chunk, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def poll(self) -> Optional[Dict[str, np.ndarray]]:
        """A ready chunk, or None without blocking."""
        try:
            return self._ready.get_nowait()
        except queue.Empty:
            return None

    def stop(self):
        self._stop_evt.set()


def chunk_positions(n_bank: int, chunk: int):
    """Write offsets tiling [0, n_bank): step-`chunk` strides plus a final
    overlapping window so the tail rows also turn over."""
    if chunk >= n_bank:
        return [0]
    pos = list(range(0, n_bank - chunk + 1, chunk))
    if pos[-1] != n_bank - chunk:
        pos.append(n_bank - chunk)
    return pos


def splice(bank: Dict[str, torch.Tensor], chunk: Dict[str, np.ndarray], start: int) -> Dict[str, torch.Tensor]:
    """A new bank: each of `bank`'s tensors cloned, with the host `chunk`'s
    rows copied into rows start.. of the clone (they must fit). `bank` is
    not changed."""
    out = {}
    for k, v in bank.items():
        rows = torch.from_numpy(chunk[k])
        out[k] = v.clone()
        out[k][start:start + rows.shape[0]].copy_(rows)
    return out


def refreshing_bank_iter(bank: Dict[str, torch.Tensor], refresher: BankRefresher, log=None,
                         stats: Optional[Dict] = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Solver data iterator: yields the live bank, splicing in refreshed
    chunks between steps. Infinite, like `itertools.repeat(bank)`. Each
    chunk's copy to the card runs here, on the caller's thread.

    With `stats`, `stats["splice_ms"]` gets each splice's host ms (the
    clone and the copy to the card, which waits for the clone)."""
    n = int(bank["data"].shape[0])
    positions = chunk_positions(n, refresher.chunk_size)
    pi = 0
    swapped = 0
    while True:
        chunk = refresher.poll()
        if chunk is not None:
            t0 = time.perf_counter()
            bank = splice(bank, chunk, positions[pi])
            if stats is not None:
                stats.setdefault("splice_ms", []).append((time.perf_counter() - t0) * 1e3)
            pi = (pi + 1) % len(positions)
            swapped += 1
            if log is not None and (swapped & (swapped - 1)) == 0:
                # powers of two: the first splices show the thread is alive,
                # the later ones do not fill the log (JAX's message counts
                # the frames queued; this one the frames spliced)
                log(f"bank refresh: {swapped * refresher.chunk_size} fresh frames "
                    f"spliced ({swapped} chunks)")
        yield bank
