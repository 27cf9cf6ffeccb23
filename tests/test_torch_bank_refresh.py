"""The port's bank refresh (`data/bank_refresh.py`) against the JAX
package's: the write offsets, the refresher's chunks (rendered from the
same seeds, packed in the bank's layout), the counter sidecar, the bank
sequence `refreshing_bank_iter` yields for a fixed schedule of ready
chunks, the Solver trained through it, and `train_net --cfg` with
TPU.BANK_REFRESH (a toy SyntheticDataset in place of the dataset, narrow
widths), resumed. Everything is held bit for bit: the same renders and the
same packing, spliced at the same rows.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

import posecnn_tpu.data.bank_refresh as JR
import posecnn_tpu.data.device_bank as JB
import posecnn_tpu.data.synthetic as JS
from posecnn_tpu.data.toy import toy as JaxToy
from posecnn_torch.config import PoseCNNConfig
from posecnn_torch.core import config as C
from posecnn_torch.core.convert import init_params_numpy, make_model
from posecnn_torch.data import bank_refresh as R
from posecnn_torch.data import device_bank as B
from posecnn_torch.data import synthetic as S
from posecnn_torch.data.lov_syn import LovSynVal
from posecnn_torch.data.toy import toy as Toy
from posecnn_torch.engine import train as T

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CAPSTONE = os.path.join(ROOT, "experiments", "cfgs", "lov_syn_capstone.yml")
NARROW = dict(trunk_scale=0.125, fc_dim=64)


def _toy_imdbs(num_images=6):
    """The JAX package's and the port's toy SyntheticDataset (96x128, 3
    objects at most), as `tests/test_bank_refresh.py` builds JAX's."""
    kw = dict(split="train", num_images=num_images, width=128, height=96, max_objects=3)
    return (JS.SyntheticDataset(JaxToy("train", num_classes=4, num_images=4), **kw),
            S.SyntheticDataset(Toy("train", num_classes=4, num_images=4), **kw))


def _wait_chunk(refresher, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        chunk = refresher.poll()
        if chunk is not None:
            return chunk
        time.sleep(0.01)
    raise AssertionError("the refresher produced nothing")


@pytest.mark.parametrize("n,c", [(8, 4), (10, 4), (3, 8), (2000, 64), (100, 7), (5, 2), (256, 64), (64, 64)])
def test_chunk_positions_match_jax(n, c):
    got = R.chunk_positions(n, c)
    assert got == JR.chunk_positions(n, c)
    covered = np.zeros(n, bool)
    for p in got:
        covered[p:p + min(c, n)] = True
    assert covered.all()


def test_refresher_chunks_bit_equal_to_jax():
    """The first two chunks of each refresher (seeds REFRESH_SEED0 + 7 ..):
    the same arrays, which are `pack_frames` of direct renders; and the
    bank layout of `build_bank` and `pack_frames` in both packages."""
    ja, pb = _toy_imdbs()
    assert R.REFRESH_SEED0 == JR.REFRESH_SEED0 == 50_000_000
    chunks = []
    for mod, ds in ((JR, ja), (R, pb)):
        r = mod.BankRefresher(mod.refresh_synthesizer(ds), g_max=3, chunk_size=2, seed_offset=7)
        r.start()
        try:
            chunks.append([_wait_chunk(r), _wait_chunk(r)])
        finally:
            r.stop()
            r.join(timeout=30)
        assert not r.is_alive()
    for n in range(2):
        a, b = chunks[0][n], chunks[1][n]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (n, k)
    direct = [pb.synth.render_scene(np.random.RandomState(R.REFRESH_SEED0 + 9 + i)) for i in range(2)]
    packed = B.pack_frames(direct, 3)
    for k in packed:
        assert np.array_equal(packed[k], chunks[1][1][k]), k
    from posecnn_tpu.data.minibatch import MinibatchConfig

    staged_j = JB.build_bank(ja, MinibatchConfig(num_classes=4, pixel_means=(102.9801, 115.9465, 122.7717)))
    staged_p = B.build_bank(pb)
    assert sorted(staged_j) == sorted(staged_p)
    for k in staged_p:
        assert np.array_equal(staged_j[k], staged_p[k]), k
        assert np.array_equal(JB.pack_frames([ja.load_frame(i) for i in range(6)], 3)[k],
                              B.pack_frames([pb.load_frame(i) for i in range(6)], 3)[k]), k


def test_counter_sidecar_survives_restart(tmp_path):
    """The counter written after each chunk: a refresher restarted at the
    same seed offset starts past it; a later offset wins."""
    _, pb = _toy_imdbs()
    path = str(tmp_path / "bank_refresh_counter.txt")
    r1 = R.BankRefresher(pb.synth, g_max=3, chunk_size=2, seed_offset=0, counter_path=path)
    r1.start()
    _wait_chunk(r1)
    r1.stop()
    r1.join(timeout=30)
    assert not r1.is_alive() and not os.path.exists(path + ".tmp")
    with open(path) as fh:
        persisted = int(fh.read())
    assert persisted >= 2 and persisted % 2 == 0 and r1.frames_rendered >= persisted
    r2 = R.BankRefresher(pb.synth, g_max=3, chunk_size=2, seed_offset=0, counter_path=path)
    r3 = R.BankRefresher(pb.synth, g_max=3, chunk_size=2, seed_offset=persisted + 100, counter_path=path)
    assert r2.seed_start == r2._counter == persisted and r3.seed_start == persisted + 100
    j2 = JR.BankRefresher(pb.synth, g_max=3, chunk_size=2, seed_offset=0, counter_path=path)
    assert j2._counter == persisted


class StubRefresher:
    """Ready chunks on a fixed schedule: poll k returns schedule[k]."""

    def __init__(self, schedule, chunk_size):
        self.schedule, self.chunk_size, self.k, self.frames_produced = list(schedule), chunk_size, 0, 0

    def poll(self):
        c = self.schedule[self.k] if self.k < len(self.schedule) else None
        self.k += 1
        self.frames_produced += self.chunk_size * (c is not None)  # read by JAX's log alone
        return c


def test_refreshing_bank_iter_yields_the_jax_sequence():
    """A 6-frame bank and 2-frame chunks ready at polls 1, 2, 4, 5 and 6:
    the 8 banks yielded equal JAX's, row for row, the offsets rotating
    0, 2, 4, 0; a bank once yielded is not changed by the later splices;
    the splice log at 1, 2 and 4 chunks."""
    _, pb = _toy_imdbs(num_images=10)
    bank_np = B.pack_frames([pb.load_frame(i) for i in range(6)], 3)
    chunks = [B.pack_frames([pb.load_frame(6 + (i % 4)), pb.load_frame(6 + ((i + 1) % 4))], 3) for i in range(5)]
    schedule = [None, chunks[0], chunks[1], None, chunks[2], chunks[3], chunks[4], None]
    jit = JR.refreshing_bank_iter(jax.device_put(bank_np), StubRefresher(schedule, 2))
    logs, stats = [], {}
    pit = R.refreshing_bank_iter(B.bank_to_device(bank_np, "cpu"), StubRefresher(schedule, 2), log=logs.append,
                                 stats=stats)
    yielded = []
    for n in range(len(schedule)):
        a, b = next(jit), next(pit)
        for k in a:
            assert np.array_equal(np.asarray(a[k]), b[k].numpy()), (n, k)
        yielded.append((b, {k: v.clone() for k, v in b.items()}))
    for n, (b, copy) in enumerate(yielded):
        for k in b:
            assert torch.equal(b[k], copy[k]), (n, k)
    assert torch.equal(yielded[0][0]["data"], torch.from_numpy(bank_np["data"]))
    last = yielded[-1][0]["data"].numpy()
    assert np.array_equal(last[0:2], chunks[3]["data"]) and np.array_equal(last[2:4], chunks[4]["data"])
    assert np.array_equal(last[4:6], chunks[2]["data"])
    assert len(stats["splice_ms"]) == 5
    assert logs == [f"bank refresh: {n * 2} fresh frames spliced ({n} chunks)" for n in (1, 2, 4)]


def test_splice_copies_without_touching_the_bank():
    bank = {"data": torch.arange(24, dtype=torch.uint8).reshape(8, 3), "meta": torch.arange(8.0).reshape(8, 1)}
    chunk = {"data": np.full((2, 3), 99, np.uint8), "meta": np.full((2, 1), -1.0, np.float32)}
    out = R.splice(bank, chunk, 4)
    assert torch.equal(out["data"][4:6], torch.full((2, 3), 99, dtype=torch.uint8))
    assert torch.equal(out["data"][:4], bank["data"][:4]) and torch.equal(out["data"][6:], bank["data"][6:])
    assert torch.equal(out["meta"][4:6], torch.full((2, 1), -1.0))
    assert torch.equal(bank["data"], torch.arange(24, dtype=torch.uint8).reshape(8, 3))
    with pytest.raises(RuntimeError):
        R.splice(bank, chunk, 7)


def test_refresh_synthesizer_reads_the_manifest():
    """A SyntheticDataset's own synthesizer; lov_syn_val_v4's from its
    manifest's render params (640x480, 5 objects, the 800-pixel gate, its
    class colours and K), as JAX's rebuilds a frozen set's; the defaults
    for a manifest without them."""
    _, pb = _toy_imdbs()
    assert R.refresh_synthesizer(pb) is pb.synth
    lv = LovSynVal()
    s = R.refresh_synthesizer(lv)
    assert (s.width, s.height, s.min_objects, s.max_objects, s.min_visible, s.t_near, s.t_far) == \
        (640, 480, 5, 5, 800, 0.5, 2.0)
    assert s.class_colors == lv._class_colors and np.array_equal(s.K, lv.load_frame(0).intrinsic_matrix)
    assert len(s.meshes) == 22 and s.meshes[0] is None and all(m.colors is not None for m in s.meshes[1:])
    lv.manifest = {k: v for k, v in lv.manifest.items() if k != "render_params"}
    s = R.refresh_synthesizer(lv)
    assert (s.width, s.height, s.max_objects, s.min_visible) == (640, 480, 5, 800)


def _narrow_bank_step(num_classes, g_max):
    cfg = PoseCNNConfig(num_classes=num_classes, num_units=16, is_train=True, keep_prob=1.0, use_crop_pool=True,
                        compute_dtype=torch.float32, hough_class_slots=2, hough_max_samples=32,
                        hough_refine_window=8, label_threshold=5, hough_gt_mix=0.5, **NARROW)
    hp = T.TrainHParams(stepsize=1000, learning_rate=0.001, margin=1e-4)
    rng = np.random.RandomState(0)
    points = torch.from_numpy(rng.randn(num_classes, 16, 3).astype(np.float32) * 0.05)
    extents = torch.from_numpy(0.05 + 0.1 * rng.rand(num_classes, 3).astype(np.float32))
    state = T.create_train_state(make_model(cfg, init_params_numpy(0, cfg), "cpu"), hp)
    step = T.make_bank_train_step(cfg, hp, points, torch.zeros(num_classes), extents, batch_size=2, max_gt=g_max)
    return step, state


def test_solver_trains_through_refreshing_iterator():
    """Solver.train driven by refreshing_bank_iter (the train_net wiring):
    8 steps at narrow widths with a chunk ready before the first fetch;
    the loss finite, the splice landing in the bank the steps sample."""
    _, pb = _toy_imdbs()
    bank = B.bank_to_device(B.build_bank(pb), "cpu")
    g_max = bank["gt_centers"].shape[1]
    step, state = _narrow_bank_step(pb.num_classes, g_max)
    seen = []

    def recording(state, batch, draws):
        seen.append(batch["data"])
        return step(state, batch, draws)

    r = R.BankRefresher(R.refresh_synthesizer(pb), g_max=g_max, chunk_size=2)
    r.start()
    try:
        deadline = time.time() + 60
        while r._ready.qsize() == 0 and time.time() < deadline:
            time.sleep(0.01)
        logged, stats = [], {}
        state, metrics = T.Solver(recording, display=4).train(
            R.refreshing_bank_iter(bank, r, stats=stats), state, max_iters=8, log=logged.append,
            handle_signals=False)
    finally:
        r.stop()
        r.join(timeout=30)
    assert np.isfinite(float(metrics["loss"])) and state.step == 8
    assert any("iter 8/8" in s for s in logged) and len(stats["splice_ms"]) >= 1
    assert not torch.equal(seen[0][0:2], bank["data"][0:2])  # the first chunk went to rows 0-1
    assert torch.equal(seen[0][2:], bank["data"][2:])


def _refresh_cfg(tmp_path):
    """lov_syn_capstone.yml with 2-frame chunks and no throttle (the toy
    bank holds 6 frames)."""
    with open(CAPSTONE) as f:
        text = f.read()
    assert "  BANK_REFRESH_CHUNK: 64\n" in text and "  BANK_REFRESH_THROTTLE: 0.3\n" in text
    text = text.replace("  BANK_REFRESH_CHUNK: 64\n", "  BANK_REFRESH_CHUNK: 2\n")
    text = text.replace("  BANK_REFRESH_THROTTLE: 0.3\n", "  BANK_REFRESH_THROTTLE: 0.0\n")
    p = tmp_path / "refresh.yml"
    p.write_text(text)
    return str(p)


def test_train_net_cfg_bank_refresh_and_resume(tmp_path, monkeypatch, capsys):
    """train_net --cfg (the capstone with 2-frame chunks) on a toy
    SyntheticDataset at narrow widths: the refresher starts at seed offset
    0, splices, and its record lands in train_timing.json; --resume from
    the step-4 snapshot starts its seeds at the sidecar's counter (larger
    than the step); the thread is gone after each run."""
    from posecnn_torch import train_net
    from posecnn_torch.data import factory

    for name in ("train_model_cfg", "test_model_cfg"):
        orig = getattr(C, name)
        monkeypatch.setattr(C, name, lambda cfg, n, _f=orig: dataclasses.replace(_f(cfg, n), **NARROW))
    monkeypatch.setattr(factory, "get_imdb", lambda name: _toy_imdbs()[1])
    orig_iter = R.refreshing_bank_iter

    def after_first_chunk(bank, refresher, **kw):
        deadline = time.time() + 60
        while refresher._ready.qsize() == 0 and time.time() < deadline:
            time.sleep(0.01)
        return orig_iter(bank, refresher, **kw)

    monkeypatch.setattr(R, "refreshing_bank_iter", after_first_chunk)
    cfg, out = _refresh_cfg(tmp_path), tmp_path / "train"
    assert train_net.main(["--cfg", cfg, "--iters", "4", "--device", "cpu", "--output", str(out)]) == 0
    log = capsys.readouterr().out
    assert "bank refresh: streaming fresh scenes in chunks of 2 (seed offset 0)" in log
    assert "fresh frames spliced (1 chunks)" in log
    rec = json.loads((out / "train_timing.json").read_text())["bank_refresh"]
    assert rec["seed_start"] == 0 and rec["chunks_spliced"] >= 1 and len(rec["splice_ms"]) == rec["chunks_spliced"]
    assert rec["frames_rendered"] >= 2 and rec["frames_per_s"] > 0
    assert (out / "vgg16_fcn_color_lov_syn_capstone_iter_4.npz").exists()
    assert not any(t.name == "bank-refresher" and t.is_alive() for t in threading.enumerate())
    counter = int((out / "bank_refresh_counter.txt").read_text())
    assert counter >= 2

    assert train_net.main(["--cfg", cfg, "--iters", "6", "--device", "cpu", "--output", str(out), "--resume"]) == 0
    log = capsys.readouterr().out
    assert "resumed from" in log and f"(seed offset {max(4, counter)})" in log
    rec = json.loads((out / "train_timing.json").read_text())
    assert rec["start_step"] == 4 and rec["end_step"] == 6 and rec["bank_refresh"]["seed_start"] == max(4, counter)
    assert int((out / "bank_refresh_counter.txt").read_text()) >= max(4, counter)
