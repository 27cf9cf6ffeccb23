"""Released-checkpoint coverage check, without TensorFlow.

Port of `tools/convert_reference_ckpt.py`. The released PoseCNN demo model
is a TF1 Saver checkpoint (`vgg16_fcn_color_single_frame_2d_pose_add_lov_
iter_160000.ckpt`). This tool reads one with `core/checkpoint.py:
load_tf1_checkpoint` (the bundle read by `core/tf1_bundle.py`, no TF) into
the flagship PoseCNN's JAX-layout parameters and reports, against the
released graph's variable inventory (every scope and leaf of the flagship
parameters under the same names, `scope/leaf`; the file also holds
`global_step`, a bare `Variable` and `<var>/Momentum` slots, which are
skipped), what was restored, missing, of another shape, and skipped.

Modes:
  --ckpt PATH     convert a TF1 checkpoint; exit 1 unless every expected
                  variable landed
  --fabricate DIR write a TF1 checkpoint with the released variable names
                  and shapes (random values and the skipped slots) and
                  convert it: a dry run of the check. Writing a TF1
                  checkpoint needs TensorFlow, imported here alone.
  --out PATH.npz  the converted parameters as a params snapshot
                  (`['params'][scope][leaf]` and `['step']`), which
                  test_net --model and online/demo --model read. The port
                  rebuilds the fixed bilinear `upscore*` filters and
                  refuses others (a fabricated file's are random).
  --report PATH   the report as JSON

Usage: python -m posecnn_torch.tools.convert_reference_ckpt (--ckpt PREFIX | --fabricate DIR)
           [--out PATH.npz] [--report PATH.json] [--num-classes 22] [--num-units 64] [--input-format COLOR]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def flagship_cfg(num_classes=22, num_units=64, input_format="COLOR"):
    import torch

    from posecnn_torch.config import PoseCNNConfig

    return PoseCNNConfig(num_classes=num_classes, num_units=num_units, input_format=input_format, vertex_reg=True,
                         pose_reg=True, is_train=False, compute_dtype=torch.float32)


def expected_reference_variables(params):
    """The released graph's variables, `scope/leaf`, sorted: every leaf of
    the flagship parameters."""
    return sorted(f"{scope}/{leaf}" for scope, leaves in params.items() for leaf in leaves)


def fabricate_reference_ckpt(out_dir, params):
    """A TF1 Saver checkpoint `<out_dir>/model.ckpt` with the released
    graph's variables (values 0.01 N(0,1) from RandomState(0) in sorted
    order), a Momentum slot for every trainable one (not the `upscore*`
    deconvolutions), `global_step` and `Variable`. Returns (prefix, {name:
    value}). Needs TensorFlow."""
    import tensorflow as _tf

    tf = _tf.compat.v1
    tf.disable_eager_execution()
    rng = np.random.RandomState(0)
    graph = tf.Graph()
    values = {}
    with graph.as_default():
        for scope, leaves in sorted(params.items()):
            with tf.variable_scope(scope):
                for leaf, ref in sorted(leaves.items()):
                    v = rng.randn(*ref.shape).astype(np.float32) * 0.01
                    values[f"{scope}/{leaf}"] = v
                    tf.get_variable(leaf, initializer=v)
                    if not scope.startswith("upscore"):
                        tf.get_variable(f"{leaf}/Momentum", initializer=np.zeros_like(v))
        tf.get_variable("global_step", initializer=np.int64(160000))
        tf.get_variable("Variable", initializer=np.float32(0.0))
        saver = tf.train.Saver()
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            path = saver.save(sess, f"{out_dir}/model.ckpt")
    return path, values


def convert(ckpt_path, params):
    """(the merged parameters, the coverage report) of a TF1 checkpoint
    against the released variable inventory."""
    from posecnn_torch.core.checkpoint import load_tf1_checkpoint
    from posecnn_torch.core.tf1_bundle import TF1Checkpoint

    reader = TF1Checkpoint(ckpt_path)
    shapes = reader.shapes()
    expected = expected_reference_variables(params)
    merged = load_tf1_checkpoint(ckpt_path, params, log=None)
    report = {"ckpt": ckpt_path, "restored": [], "missing_in_ckpt": [], "shape_mismatch": [],
              "skipped_ckpt_vars": []}
    for name in expected:
        scope, leaf = name.split("/")
        if name not in shapes:
            report["missing_in_ckpt"].append(name)
            continue
        want, got = tuple(params[scope][leaf].shape), tuple(shapes[name])
        if want != got:
            report["shape_mismatch"].append({"var": name, "ckpt": list(got), "target": list(want)})
            continue
        if not np.allclose(np.asarray(merged[scope][leaf]), reader.get_tensor(name)):
            report["shape_mismatch"].append({"var": name, "error": "value not written by converter"})
            continue
        report["restored"].append(name)
    report["skipped_ckpt_vars"] = sorted(set(shapes) - set(expected))
    report["ok"] = not report["missing_in_ckpt"] and not report["shape_mismatch"]
    report["n_restored"] = len(report["restored"])
    report["n_expected"] = len(expected)
    return merged, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", help="a TF1 checkpoint prefix")
    ap.add_argument("--fabricate", help="a directory: fabricate a released-shaped checkpoint there and convert it")
    ap.add_argument("--out", help="write the converted parameters as an npz")
    ap.add_argument("--report", help="write the coverage report as JSON")
    ap.add_argument("--num-classes", type=int, default=22)
    ap.add_argument("--num-units", type=int, default=64)
    ap.add_argument("--input-format", default="COLOR")
    args = ap.parse_args(argv)
    if bool(args.ckpt) == bool(args.fabricate):
        ap.error("exactly one of --ckpt / --fabricate required")

    from posecnn_torch.core.convert import init_params_numpy

    params = init_params_numpy(0, flagship_cfg(args.num_classes, args.num_units, args.input_format))
    ckpt = args.ckpt
    if args.fabricate:
        ckpt, _ = fabricate_reference_ckpt(args.fabricate, params)
        print(f"fabricated released-shaped checkpoint: {ckpt}")
    merged, report = convert(ckpt, params)
    print(f"restored {report['n_restored']}/{report['n_expected']} expected variables; skipped "
          f"{len(report['skipped_ckpt_vars'])} optimizer/step slots")
    for k in ("missing_in_ckpt", "shape_mismatch"):
        for item in report[k]:
            print(f"  {k}: {item}")
    if args.report:
        with open(args.report, "w") as fh:
            json.dump(report, fh, indent=1)
    if args.out:
        arrays = {f"['params']['{s}']['{k}']": v for s, leaves in merged.items() for k, v in leaves.items()}
        np.savez(args.out, **arrays, **{"['step']": np.asarray(160000, np.int32)})
        print(f"wrote {args.out}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
