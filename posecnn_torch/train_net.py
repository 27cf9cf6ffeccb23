"""Train PoseCNN on the card.

With --cfg, the port of `tools/train_net.py` for the VGG16 PoseCNN: the
config is read from the `.yml` file (`core.config.cfg_from_file`),
`np.random.seed(RNG_SEED)` unless --rand, the dataset comes from
`data.factory` (--imdb, default toy_train) with its roidb doubled by flipped
entries under TRAIN.USE_FLIPPED, and the output directory is
output/<EXP_DIR>/<imdb>/<network> unless --output. The model, the
hyper-parameters and the minibatch settings are built from the config
(`core.config`), the weights drawn from numpy seed RNG_SEED
(`core.convert.init_params_numpy`), the ADD loss reads the dataset's points
rescaled (`data.minibatch.rescale_points`), and SNAPSHOT_ITERS,
SNAPSHOT_PREFIX, CHECKPOINT_OPT_STATE, SNAPSHOT_FINAL and DISPLAY set the
solver. With TPU.DEVICE_BANK the step samples from every frame of the
dataset held on the card, and with TPU.BANK_REFRESH a host thread renders
fresh scenes (`data.bank_refresh`) that are spliced into that bank between
steps; the snapshot is restored before the refresh starts, whose seeds
begin at the resume step; otherwise a thread assembles host minibatches
(`data.layer.GtSynthesizeLayer` through `prefetch`, TPU.PREFETCH deep) and
the solver copies each to the card; for INPUT DEPTH, NORMAL and RGBD that
thread also jitters and noises the colour image and builds the depth or
normal image (`data.minibatch.get_minibatch`), and RGBD trains the dual
tower; with VERTEX_REG_3D the vertex head learns object coordinates from
the frames' vertmaps (a dataset whose frames have none, such as every one
in this repository, stops at the first batch with ValueError, where the
JAX package raises TypeError). NETWORK VGG16FULL (or --network
vgg16_full) trains the all-scale network (`models.posecnn_full`) through
the same step, with the hard-label gate of its cross entropy at 0.7
whatever THRESHOLD_LABEL says; NETWORK VGG16GAN trains PoseCNN, as the JAX
CLI does, on host batches that also carry the GAN blobs (TRAIN.GAN: the
jitter and the noise on the host, `data_gan`, `gan_z`), which the step
does not read. TRAIN.ADAPT adds the domain head and its loss; as in the
JAX CLI, the adaptation frames come only from TRAIN.ADAPT_ROOT (its first
ADAPT_NUM *.png and *.jpg files, sorted; PNG read by `utils.png`, and a
JPEG among them raises NotImplementedError naming it before the first
step), so without it (the shipped cfgs) the data stream has none.
TRAIN.SYNTHESIZE mixes in synthetic batches (SYN_RATIO to 1): rendered by
`data.synthetic.build_ycb_synthesizer` with SYN_ONLINE, else read from
TRAIN.SYNROOT (`data.synthetic.OfflineSynReader`, frame (SYNITER +
randint(SYNNUM)) % SYNNUM), each pasted over a background of
`data.layer.build_background_paths` under $POSECNN_DATA (or data/) where
there are any (a background that is not a PNG raises NotImplementedError
before the first step). NETWORK FCN8VGG (or --network fcn8_vgg)
trains FCN-8s on the segmentation loss alone (`seg_run`, the JAX CLI's
`train_segmentation`), under output/<EXP_DIR>/<imdb>/fcn8_vgg; NETWORK
RESNET50 or --network resnet50 (under any config but VGG16DET's, as in the
JAX CLI) ResNet-50 the same way, under .../resnet50. NETWORK
VGG16DET trains the detection network (`det_run`, the JAX CLI's
`train_det`: one raw frame a step, no resume), under
output/<EXP_DIR>/<imdb>/vgg16_det. A config with a setting the port
does not run raises NotImplementedError naming it. --weights (a Caffe
vgg16.npy: each op's weights into its scope and its `_p`/`_d` dual-tower
copies) and --ckpt (a TF1 checkpoint, read without TensorFlow: every
`scope/leaf` variable of the model's shape, the optimizer's slots and the
step skipped) set the initial weights of PoseCNN and VGG16FULL, as in the
JAX CLI, which reads neither for FCN-8s, ResNet-50 or VGG16DET. With
TPU.DEVICE_TARGETS False the host thread builds dense batches (float
images with the jitter and the noise applied, the (B,H,W,3C) vertex
targets and weights; `data.minibatch.get_minibatch`) and the vertex loss
is the dense smooth L1 (`ops.losses.smooth_l1_loss_vertex`); a config that
also asks Hough for the GT centres (HOUGH_FROM_GT, HOUGH_GT_MIX) is
refused, as JAX's step raises KeyError there. With TPU.DEBUG_NANS the
steps run under `utils.debug_nans` (FloatingPointError at the first
operation with a NaN output, forward or backward; `train_timing.json`
counts the outputs checked); with TPU.DEBUG_DISABLE_JIT too, every
operation of a step is checked as it runs, as under JAX's
`jax_disable_jit`.

Without --cfg, the flagship run: `engine.train.Solver` over the step of
`entry.train_entry` (a device bank of `data/lov_syn_val_v4/`), with the
capstone's solver settings (`config.FLAGSHIP_SOLVER`). The JAX CLI's own
default without a config is INPUT RGBD; the port's is the flagship run.

Either way: a log line and a `train_metrics.csv` row every DISPLAY steps,
snapshots in the JAX npz layout (`<prefix>_iter_N.npz`) every SNAPSHOT_ITERS
steps and at the end, and one at the step reached when SIGTERM or SIGINT
arrives; --resume restarts from the latest snapshot in the output
directory. Each log line starts with the seconds since the program started.
At the end, `train_timing.json` in the output directory holds per-step
milliseconds (`data_wait`: the main thread waiting for the next batch, a
bank refresh's splices included; `step`: the step's host time;
`host/<layer>`: the host time of the step's spans of each layer of
`core.profiler.LAYERS` (sample, trunk, heads, hough, pose_head, losses,
backward, optimizer, flow_warp; 0.0 where a step does not run it), its
launches and any wait for the card inside them; `step_stream`: CUDA events
around the step) and, on a card, `cuda_malloc` (the caching allocator's
cudaMallocs since the step before), the kernels' launches, the
peak device memory of the process (`peak_memory_mib`, on a card), and
with the bank refresh its record (`bank_refresh`: the first seed, frames
rendered, chunks spliced, each splice's ms, the render seconds and frames
a second of the thread).

Several processes (ranks; `parallel/launch.py`): started with
POSECNN_COORDINATOR, POSECNN_NUM_PROCESSES and POSECNN_PROCESS_ID set (one
process a rank, as JAX's CLI), each rank joins the process group first
(`launch.initialize`; NCCL on cuda:<local rank>, gloo on the CPU or where
POSECNN_BACKEND asks for it) and the --cfg run trains data-parallel over a
mesh of (N, 1), as JAX's Solver builds `make_mesh()`: every rank builds the
global host batch from the same RNG_SEED stream and keeps its images
(`mesh.shard_batch`), and the step computes the one-process step's function
on the global batch. Rank 0 alone logs and writes the metrics, the snapshots
and `train_timing.json`, which then holds every rank's milliseconds,
launches and peak memory under `by_rank`, with the world size and the mesh.
TPU.DEVICE_BANK, the run without --cfg (a device bank), FCN8VGG, RESNET50
and VGG16DET are refused at more than one rank; VGG16FULL trains over the
mesh as PoseCNN does.

With --vis, or TRAIN.VISUALIZE, a --cfg run of PoseCNN (or VGG16FULL) on
host minibatches writes the first 8 of them as
<output>/vis_minibatch/iter<step:06d>_im<i>.png
(`engine.visualize.MinibatchVisualizer`: the image, the label overlay,
the GT poses' projected 3D boxes, the GT centres), drawn from the host
batch before its copy to the card; the segmentation and detection runs
draw none, as in the JAX CLI, and a device-bank run refuses it.

Usage: python -m posecnn_torch.train_net [--cfg FILE.yml] [--imdb NAME] [--iters N]
           [--weights vgg16.npy] [--ckpt TF1_PREFIX] [--output DIR] [--resume] [--rand] [--vis] [--device cuda]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import pprint
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def refuse_at_world(cfg, network: str, world: int) -> None:
    """What a run of more than one rank does not train: TPU.DEVICE_BANK
    (JAX's bank step is single-device by design, `engine/train.py:439-440`:
    each process would train alone and all would write to one output
    directory), and the networks whose step has no mesh here."""
    if world <= 1:
        return
    if cfg.TPU.DEVICE_BANK:
        raise ValueError(f"TPU.DEVICE_BANK trains on one device (the JAX bank step ignores the mesh): "
                         f"not at {world} ranks")
    if network in ("fcn8_vgg", "resnet50", "vgg16_det"):
        raise NotImplementedError(f"{network} at {world} ranks: its data-parallel step is not ported")


def run_dir_name(cfg, network: str) -> str:
    """The last part of a --cfg run's default output directory
    (output/<EXP_DIR>/<imdb>/<this>): the segmentation and detection runs
    name their network; PoseCNN's runs (VGG16FULL's too) the --network
    flag, as the JAX CLI does."""
    from posecnn_torch.core import config as C

    name = C.pick_network(cfg.NETWORK, network)
    return name if name in ("fcn8_vgg", "resnet50", "vgg16_det") else network


def cfg_run(args, log, mesh=None):
    """(step, state, open_data, Solver arguments, output directory) of a
    --cfg run (`tools/train_net.py:main`). `open_data(start_iter)` returns
    the data iterator and a function (or None) that ends the data source
    and returns its entries for `train_timing.json`: with the bank refresh
    the refresher's record (`bank_refresh`), with host batches the count
    made from each source (`batches_by_source`: real, syn, adapt). It is
    called after the resume, since the refresh's seeds start from the
    resume iteration. `mesh` (more than one rank): the host batches are
    this rank's part of each global batch and the step is the mesh's."""
    import numpy as np
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.core.checkpoint import load_tf1_checkpoint, load_vgg16_npy
    from posecnn_torch.core.convert import make_model
    from posecnn_torch.models.posecnn_full import CE_THRESHOLD, make_full_model
    from posecnn_torch.data.device_bank import bank_to_device, build_bank
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.layer import prefetch
    from posecnn_torch.data.minibatch import rescale_points
    from posecnn_torch.engine import train as T
    from posecnn_torch.engine.test import set_float32_precision
    from posecnn_torch.models.factory import get_network
    from posecnn_torch.parallel.mesh import shard_batch

    cfg = C.cfg_from_file(args.cfg)
    args.debug_nans = (cfg.TPU.DEBUG_NANS, cfg.TPU.DEBUG_DISABLE_JIT)
    # NETWORK and --network with the JAX CLI's precedence
    # (tools/train_net.py:83-105); VGG16GAN trains PoseCNN; a network the
    # port does not run raises here
    name = C.pick_network(cfg.NETWORK, args.network)
    init_fn, forward_fn = get_network(name)
    refuse_at_world(cfg, name, 1 if mesh is None else mesh.world)
    if not args.rand:
        np.random.seed(cfg.RNG_SEED)
    log("Using config:\n" + pprint.pformat(cfg))
    imdb = get_imdb(args.imdb)
    if cfg.TRAIN.USE_FLIPPED:
        try:
            imdb.append_flipped_images()
            log("appended flipped images")
        except NotImplementedError:
            log("dataset has no roidb; USE_FLIPPED ignored")
    log(f"Loaded dataset `{imdb.name}`: {imdb.num_images} images")
    output = args.output or C.get_output_dir(cfg, imdb.name, run_dir_name(cfg, args.network))
    log(f"Output will be saved to {output}")
    dev = torch.device(args.device)
    set_float32_precision()
    if (args.vis or cfg.TRAIN.VISUALIZE) and name in ("fcn8_vgg", "resnet50", "vgg16_det"):
        log(f"TRAIN.VISUALIZE: no minibatches are drawn for {name} (the JAX CLI has no hook there)")
    if (args.weights or args.ckpt) and name in ("fcn8_vgg", "resnet50", "vgg16_det"):
        log(f"--weights/--ckpt: not read for {name} (the JAX CLI reads them for PoseCNN alone)")
    if name in ("fcn8_vgg", "resnet50"):
        return seg_run(cfg, imdb, dev, output, name, init_fn, forward_fn)
    if name == "vgg16_det":
        return det_run(args, cfg, imdb, dev, output, init_fn)

    model_cfg = C.train_model_cfg(cfg, imdb.num_classes)
    hp = C.train_hparams(cfg)
    mcfg = C.minibatch_cfg(cfg, imdb.num_classes)
    vis = None
    points_raw = np.asarray(imdb._points_all, np.float32)
    extents, symmetry = np.asarray(imdb._extents, np.float32), np.asarray(imdb._symmetry, np.float32)
    points = rescale_points(points_raw, extents, symmetry, mcfg.is_symmetric)
    points, symmetry, extents, points_raw = (torch.from_numpy(a).to(dev)
                                             for a in (points, symmetry, extents, points_raw))
    full = name == "vgg16_full"
    params = init_fn(cfg.RNG_SEED, model_cfg)
    # the initial weights of --weights, then --ckpt (tools/train_net.py:300-309)
    if args.weights:
        params = load_vgg16_npy(args.weights, params, log=log)
    if args.ckpt:
        params = load_tf1_checkpoint(args.ckpt, params, log=log)
    model = (make_full_model if full else make_model)(model_cfg, params, dev)
    state = T.create_train_state(model, hp)
    # vgg16_full: its own forward and the 0.7 gate (tools/train_net.py:94-105)
    step_kw = dict(forward_fn=forward_fn, ce_threshold=CE_THRESHOLD) if full else {}
    if cfg.TPU.DEVICE_BANK:
        T_ = cfg.TRAIN
        # the bank holds raw COLOR frames at scale 1 (tools/train_net.py:331-336)
        if T_.USE_FLIPPED or tuple(T_.SCALES_BASE) != (1.0,) or cfg.INPUT != "COLOR" or T_.ADAPT or full:
            raise ValueError("TPU.DEVICE_BANK supports the fixed single-frame COLOR flagship path")
        if args.vis or T_.VISUALIZE:
            raise ValueError("TRAIN.VISUALIZE draws host minibatches, and TPU.DEVICE_BANK has none (the JAX "
                             "Solver's hook reads the bank's 'gt_label_2d', which it lacks: KeyError)")
        bank = bank_to_device(build_bank(imdb, mcfg.max_gt), dev)
        log(f"device bank: {bank['data'].shape[0]} frames on {dev}")
        step = T.make_bank_train_step(model_cfg, hp, points, symmetry, extents, batch_size=T_.IMS_PER_BATCH,
                                      max_gt=cfg.TPU.MAX_GT, chromatic=T_.CHROMATIC, add_noise=T_.ADD_NOISE,
                                      points_raw=points_raw if T_.MATCHING else None)
        if cfg.TPU.BANK_REFRESH:
            def open_data(start_iter):
                return refreshing_data(imdb, bank, cfg, start_iter, output, log)
        else:
            def open_data(start_iter):
                return itertools.repeat(bank), None
    else:
        layer = host_layer(cfg, imdb, mcfg, log)
        # the raw metre-scale clouds for the matching loss (tools/train_net.py:275-277)
        step = T.make_train_step(model_cfg, hp, points, symmetry, extents, mesh=mesh, points_raw=points_raw,
                                 **step_kw)
        if (args.vis or cfg.TRAIN.VISUALIZE) and (mesh is None or mesh.rank == 0):  # rank 0 draws its images
            from posecnn_torch.engine.visualize import MinibatchVisualizer

            vis = MinibatchVisualizer(output, num_classes=cfg.TRAIN.NUM_CLASSES, extents=np.asarray(imdb._extents),
                                      pixel_means=mcfg.pixel_means)

        def batches():
            if mesh is None:
                return iter(layer)
            # every rank draws the global batch from one seed; each keeps its images
            return (shard_batch(mesh, b) for b in layer)

        def open_data(start_iter):
            return prefetch(batches(), depth=cfg.TPU.PREFETCH), lambda: {"batches_by_source": dict(layer.sources)}
    return step, state, open_data, {**C.solver_settings(cfg), "vis_hook": vis}, output


def host_layer(cfg, imdb, mcfg, log):
    """The host minibatch source of a --cfg run (`tools/train_net.py:
    167-248`): `GtSynthesizeLayer` over the dataset with the synthetic
    stream (`synthetic_source`) and the adaptation stream
    (`adaptation_source`) the config asks for, seeded with RNG_SEED."""
    from posecnn_torch.data.layer import GtSynthesizeLayer

    T_ = cfg.TRAIN
    syn_frames, backgrounds = synthetic_source(cfg, imdb, log)
    adapt_frames = adaptation_source(cfg) if T_.ADAPT and T_.ADAPT_ROOT else None
    return GtSynthesizeLayer(imdb, mcfg, ims_per_batch=T_.IMS_PER_BATCH, synthesize=T_.SYNTHESIZE,
                             syn_ratio=T_.SYN_RATIO, syn_frames=syn_frames, adapt=adapt_frames is not None,
                             adapt_ratio=T_.ADAPT_RATIO, adapt_frames=adapt_frames, backgrounds=backgrounds,
                             seed=cfg.RNG_SEED)


def synthetic_source(cfg, imdb, log):
    """(syn_frames, backgrounds) of TRAIN.SYNTHESIZE (`tools/train_net.py:
    167-196,226-233`), or (None, []) without it. SYN_ONLINE: scenes rendered
    by `build_ycb_synthesizer` over the dataset (at SYN_WIDTH x SYN_HEIGHT,
    SYN_TNEAR to SYN_TFAR, with the `poses.txt` bank of the dataset's
    directory under SYN_SAMPLE_POSE); else frame (SYNITER +
    rng.randint(SYNNUM)) % SYNNUM of `OfflineSynReader(SYNROOT, SYNNUM)`.
    The backgrounds are the PNG paths of `build_background_paths` under
    $POSECNN_DATA (or data/); any other file there raises
    NotImplementedError naming it."""
    import numpy as np

    from posecnn_torch.data.layer import build_background_paths
    from posecnn_torch.data.synthetic import OfflineSynReader, build_ycb_synthesizer
    from posecnn_torch.utils.png import is_png

    T_ = cfg.TRAIN
    if not T_.SYNTHESIZE:
        return None, []
    if T_.SYN_ONLINE:
        pose_bank = None
        bank_file = os.path.join(getattr(imdb, "_lov_path", ""), "poses.txt")
        if T_.SYN_SAMPLE_POSE and os.path.exists(bank_file):
            pose_bank = np.loadtxt(bank_file).reshape(-1, 4)
        synth = build_ycb_synthesizer(imdb, width=T_.SYN_WIDTH, height=T_.SYN_HEIGHT, t_near=T_.SYN_TNEAR,
                                      t_far=T_.SYN_TFAR, pose_bank=pose_bank)

        def syn_frames(i, rng):
            return synth.render_scene(rng)
    else:
        if not os.path.isdir(T_.SYNROOT):
            raise FileNotFoundError(f"TRAIN.SYNROOT {T_.SYNROOT}: no such directory (the data_syn frames)")
        reader = OfflineSynReader(T_.SYNROOT, num=T_.SYNNUM)

        def syn_frames(i, rng):
            return reader.load_frame((T_.SYNITER + rng.randint(reader.num)) % reader.num)
    backgrounds = build_background_paths(os.environ.get("POSECNN_DATA", "data"), cfg.INPUT)
    for path in backgrounds:
        if not is_png(path):
            raise NotImplementedError(f"background {path}: not a PNG file (JPEG and other formats are not read)")
    if backgrounds:
        log(f"{len(backgrounds)} background images")
    return syn_frames, backgrounds


def adaptation_source(cfg):
    """The adaptation frames of TRAIN.ADAPT_ROOT (`tools/train_net.py:
    198-225`): one of the first ADAPT_NUM of its sorted *.png and *.jpg
    files drawn by `rng.randint` for each frame, read as cv2's IMREAD_COLOR
    (`utils.png.imread`), unlabelled; None when the directory has none. A
    JPEG among them raises NotImplementedError naming it (no JPEG decoder
    here)."""
    import glob

    import numpy as np

    from posecnn_torch.data.minibatch import Frame
    from posecnn_torch.utils.png import IMREAD_COLOR, imread

    root, num = cfg.TRAIN.ADAPT_ROOT, cfg.TRAIN.ADAPT_NUM
    paths = sorted(glob.glob(os.path.join(root, "*.png")) + glob.glob(os.path.join(root, "*.jpg")))[:num]
    jpeg = [p for p in paths if p.endswith(".jpg")]
    if jpeg:
        raise NotImplementedError(f"TRAIN.ADAPT_ROOT: {jpeg[0]} is a JPEG ({len(jpeg)} of {len(paths)} files): "
                                  "only PNG frames are read")
    if not paths:
        return None

    def adapt_frames(i, rng):
        im = imread(paths[rng.randint(len(paths))], IMREAD_COLOR)
        h, w = im.shape[:2]
        return Frame(color=im, label=np.zeros((h, w), np.int32), cls_indexes=np.zeros(0, np.float32),
                     poses=np.zeros((3, 4, 0), np.float32), center=np.zeros((0, 2), np.float32),
                     intrinsic_matrix=np.eye(3), is_adaptation=True)

    return adapt_frames


def seg_run(cfg, imdb, dev, output, name, init_fn, forward_fn):
    """What `cfg_run` returns for the segmentation networks
    (`tools/train_net.py:385-442`, `train_segmentation`): network `name`
    (fcn8_vgg, or resnet50; the factory's `init_fn`, `forward_fn`) from
    numpy seed RNG_SEED, FCN-8s with dropout at keep 0.5 and ResNet-50
    without any, `engine.train.make_seg_train_step` on host minibatches of
    the config's INPUT without vertex targets, into `output`; the solver
    snapshots at the end of the run whatever SNAPSHOT_FINAL says, as the
    JAX loop does."""
    from posecnn_torch.core import config as C
    from posecnn_torch.data.layer import GtSynthesizeLayer, prefetch
    from posecnn_torch.engine import train as T
    from posecnn_torch.models.fcn8 import make_fcn8
    from posecnn_torch.models.resnet50 import make_resnet50

    n = imdb.num_classes
    hp, mcfg = C.seg_settings(cfg, n)
    make = make_fcn8 if name == "fcn8_vgg" else make_resnet50
    state = T.create_train_state(make(n, init_fn(cfg.RNG_SEED, n), dev), hp)

    if name == "fcn8_vgg":
        def apply_fn(model, data, draws):
            return forward_fn(model, data, n, keep_prob=0.5, draws=draws)
    else:
        def apply_fn(model, data, draws):
            return forward_fn(model, data, n)

    step = T.make_seg_train_step(apply_fn, hp, n)
    layer = GtSynthesizeLayer(imdb, mcfg, ims_per_batch=cfg.TRAIN.IMS_PER_BATCH, seed=cfg.RNG_SEED)

    def open_data(start_iter):
        return prefetch(iter(layer), depth=cfg.TPU.PREFETCH), None

    return step, state, open_data, {**C.solver_settings(cfg), "snapshot_final": True}, output


def det_run(args, cfg, imdb, dev, output, init_fn):
    """What `cfg_run` returns for VGG16DET (`tools/train_net.py:445-498`,
    `train_det`): the detection network (`core.config.det_model_cfg`: the
    DetConfig defaults, not TRAIN.RPN_*) from numpy seed RNG_SEED, one
    image a step whatever IMS_PER_BATCH says, the raw colour frame (no
    chroma, no noise) with its label-extent GT boxes
    (`engine.train.det_batch_from_frame`), the frames in the order of
    `RandomState(RNG_SEED).permutation`, momentum SGD without clipping, a
    snapshot at the last step whatever SNAPSHOT_FINAL says (the JAX loop
    writes one there). No --resume, as in the JAX loop."""
    import numpy as np
    import torch

    from posecnn_torch.core import config as C
    from posecnn_torch.data.layer import prefetch
    from posecnn_torch.data.minibatch import rescale_points
    from posecnn_torch.engine import train as T
    from posecnn_torch.models.detection import make_det_model

    if args.resume:
        raise NotImplementedError("--resume: the detection trainer has no resume, as in the JAX CLI")
    det_cfg = C.det_model_cfg(cfg, imdb.num_classes, train=True)
    hp = C.det_hparams(cfg)
    symmetry = np.asarray(imdb._symmetry, np.float32)
    points = rescale_points(np.asarray(imdb._points_all, np.float32), np.asarray(imdb._extents), symmetry)
    points, symmetry = torch.from_numpy(points).to(dev), torch.from_numpy(symmetry).to(dev)
    state = T.create_train_state(make_det_model(det_cfg, init_fn(cfg.RNG_SEED, det_cfg), dev), hp)
    step = T.make_det_train_step(det_cfg, hp, points, symmetry)
    order = np.random.RandomState(cfg.RNG_SEED).permutation(imdb.num_images)

    def batches(start_iter):
        for it in itertools.count(start_iter):
            yield T.det_batch_from_frame(imdb.load_frame(int(order[it % imdb.num_images])), max_gt=cfg.TPU.MAX_GT)

    def open_data(start_iter):
        return prefetch(batches(start_iter), depth=cfg.TPU.PREFETCH), None

    return step, state, open_data, {**C.solver_settings(cfg), "snapshot_final": True}, output


def refreshing_data(imdb, bank, cfg, start_iter: int, output: str, log):
    """The TPU.BANK_REFRESH iterator (`tools/train_net.py:353-375`): a
    thread renders fresh scenes in chunks of BANK_REFRESH_CHUNK frames
    (BANK_REFRESH_THROTTLE s of sleep after each) and the iterator splices
    them into the bank; the seeds start from `start_iter` or the counter
    sidecar `<output>/bank_refresh_counter.txt`, whichever is larger.
    Returns (iterator, a function that stops the refresher's thread and
    returns its record)."""
    from posecnn_torch.data.bank_refresh import BankRefresher, refresh_synthesizer, refreshing_bank_iter

    os.makedirs(output, exist_ok=True)
    refresher = BankRefresher(
        refresh_synthesizer(imdb), g_max=bank["gt_centers"].shape[1], chunk_size=cfg.TPU.BANK_REFRESH_CHUNK,
        seed_offset=start_iter, throttle_sec=cfg.TPU.BANK_REFRESH_THROTTLE,
        counter_path=os.path.join(output, "bank_refresh_counter.txt"))
    refresher.start()
    log(f"bank refresh: streaming fresh scenes in chunks of {refresher.chunk_size} "
        f"(seed offset {refresher.seed_start})")
    stats = {"splice_ms": []}

    def finish():
        r = refresher
        r.stop()
        r.join(timeout=30)
        return {"bank_refresh": {
            "seed_start": r.seed_start, "frames_rendered": r.frames_rendered,
            "chunks_spliced": len(stats["splice_ms"]), "splice_ms": stats["splice_ms"],
            "render_s": r.render_s, "frames_per_s": r.frames_rendered / r.render_s if r.render_s else None}}

    return refreshing_bank_iter(bank, refresher, log=log, stats=stats), finish


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=40000, help="train up to this step")
    ap.add_argument("--cfg", default=None, help="an experiments/cfgs/*.yml config (without it: the flagship run)")
    ap.add_argument("--imdb", default=None, help="dataset (with --cfg; default toy_train)")
    ap.add_argument("--network", default="vgg16_convs")
    ap.add_argument("--rand", action="store_true", help="do not seed numpy's global generator with RNG_SEED")
    ap.add_argument("--weights", default=None, help="vgg16.npy initial weights (with --cfg)")
    ap.add_argument("--ckpt", default=None, help="TF1 checkpoint of initial weights (with --cfg; no TF needed)")
    ap.add_argument("--output", default=None, help="snapshot and metrics directory")
    ap.add_argument("--resume", action="store_true", help="resume from the latest snapshot in the output directory")
    ap.add_argument("--vis", action="store_true",
                    help="render host minibatches (TRAIN.VISUALIZE) under <output>/vis_minibatch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from posecnn_torch.parallel import launch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("train_net: no CUDA device (pass --device cpu to train on the CPU)", file=sys.stderr)
        return 2
    args.device = launch.rank_device(args.device)
    world = launch.initialize(device=args.device)
    try:
        return _train(args, ap, t_start, world)
    finally:
        launch.shutdown()


def _train(args, ap, t_start: float, world: int) -> int:
    import torch

    from posecnn_torch.engine.train import Solver
    from posecnn_torch.ops import compute_flow, conv3x3, nms, voting
    from posecnn_torch.parallel.mesh import MeshSpec, make_mesh
    from posecnn_torch.utils.debug_nans import debug_nans

    # the mesh of JAX's Solver, make_mesh(): every rank on the data axis
    mesh = make_mesh(MeshSpec(), world) if world > 1 else None
    rank0 = mesh is None or mesh.rank == 0

    def log(msg: str) -> None:
        if rank0:
            print(f"[{time.perf_counter() - t_start:.3f}s] {msg}", flush=True)

    if mesh is not None:
        log(f"{world} ranks, mesh {mesh.shape}, backend {torch.distributed.get_backend()}")
    if args.cfg:
        args.imdb = args.imdb or "toy_train"
        step, state, open_data, solver_kw, output = cfg_run(args, log, mesh)
    else:
        if mesh is not None:
            raise ValueError("the run without --cfg trains from a device bank, on one device: not at "
                             f"{world} ranks")
        from posecnn_torch.config import EXP_DIR, FLAGSHIP_SOLVER
        from posecnn_torch.entry import train_entry

        if args.imdb not in (None, "lov_syn_val_v4"):
            ap.error("without --cfg the flagship run trains on lov_syn_val_v4")
        if args.vis:
            ap.error("--vis draws host minibatches; the flagship run trains from a device bank")
        if args.weights or args.ckpt:
            ap.error("--weights and --ckpt are read by the --cfg runs")
        output = args.output or os.path.join(ROOT, "output", EXP_DIR, "lov_syn_val_v4", "vgg16_convs")
        step, state, bank = train_entry(args.device)
        log(f"bank: {bank['data'].shape[0]} frames on {args.device}; output {output}")
        solver_kw = FLAGSHIP_SOLVER

        def open_data(start_iter):
            return itertools.repeat(bank), None
    solver = Solver(step, output_dir=output, mesh=mesh, **solver_kw)
    start = 0
    if args.resume:  # det_run refuses --resume
        state, start = solver.resume(state, log=log)
    data_iter, finish_data = open_data(start)
    timings = {}
    voting.VOTE_LAUNCHES = conv3x3.CONV3X3_LAUNCHES = nms.NMS_LAUNCHES = compute_flow.FLOW_WARP_LAUNCHES = 0
    data_record = {}
    try:
        # TPU.DEBUG_NANS: every step's forward and backward under the NaN check
        with debug_nans(*getattr(args, "debug_nans", (False,))) as nan_mode:
            solver.train(data_iter, state, args.iters, log=log, start_iter=start, timings=timings)
    finally:
        close = getattr(data_iter, "close", None)
        if close is not None:
            close()
        if finish_data is not None:
            data_record = finish_data()
    launches = {"hough_vote": voting.VOTE_LAUNCHES, "conv3x3": conv3x3.CONV3X3_LAUNCHES, "nms": nms.NMS_LAUNCHES,
                "flow_warp": compute_flow.FLOW_WARP_LAUNCHES}
    cuda = args.device.startswith("cuda")
    device = torch.cuda.get_device_name(torch.device(args.device)) if cuda else "cpu"
    record = {"device": device, "start_step": start, "end_step": state.step, "launches": launches, "ms": timings}
    if cuda:
        record["peak_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
    if nan_mode is not None:
        record["debug_nans_checked_outputs"] = nan_mode.checked
    if mesh is not None:
        # each rank's own record; rank 0's stays at the top level
        ranks = mesh.gather_objects({k: record.get(k) for k in ("device", "end_step", "launches", "ms",
                                                               "peak_memory_mib")})
        record.update(world_size=mesh.world, mesh=mesh.shape, by_rank=ranks)
    record.update(data_record)
    if rank0:
        os.makedirs(output, exist_ok=True)
        with open(os.path.join(output, "train_timing.json"), "w") as f:
            json.dump(record, f, indent=1)
    if "batches_by_source" in data_record:
        log(f"host batches made by source (the prefetched ones too): {data_record['batches_by_source']}")
    log(f"done at iteration {state.step}; launches hough_vote {launches['hough_vote']} "
        f"conv3x3 {launches['conv3x3']} nms {launches['nms']} flow_warp {launches['flow_warp']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
