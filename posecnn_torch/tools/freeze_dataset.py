"""Freeze a synthetic dataset split to disk with a hash manifest.

Port of `tools/freeze_dataset.py`: renders every frame of a (deterministic)
synthetic imdb to npz files plus a `manifest.json` of per-frame content
hashes (`data.synthetic.freeze_dataset`, the JAX package's bytes). The
manifest is committed to git; the npz files are regenerable from it
(`--verify` renders again and checks every digest, exit code 1 on a
mismatch). Frozen directories are read back by `data.lov_syn.LovSynVal`.

A registered frozen set (or another size, `--num`) is rendered anew as
`SyntheticDataset(<base>, split="val")`: val seeds are i + 10,000,000, so a
larger set extends the same held-out seed region. The base is YCB-Video's
train split (`--base lov_train`, as the JAX tool's `lov("train")`: it needs
the dataset under $POSECNN_DATA); any registered imdb with object models
serves. It renders on the host (C++ rasterizer) and does no device work,
as the JAX tool.

Usage: python -m posecnn_torch.tools.freeze_dataset --imdb lov_syn_val --out data/lov_syn_val_v3
       python -m posecnn_torch.tools.freeze_dataset --imdb lov_syn_val --num 256 --out data/lov_syn_val_v4
       python -m posecnn_torch.tools.freeze_dataset --verify data/lov_syn_val_v3
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--imdb", default="lov_syn_val")
    ap.add_argument("--out", default=None)
    ap.add_argument("--num", type=int, default=None,
                    help="frame count for the re-frozen split (default: keep the registered dataset's size)")
    ap.add_argument("--verify", default=None, help="snapshot dir to verify against a fresh render")
    ap.add_argument("--base", default="lov_train", help="the imdb whose object models a new split renders")
    args = ap.parse_args(argv)

    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.data.lov_syn import frame_digest
    from posecnn_torch.data.synthetic import SyntheticDataset, freeze_dataset

    if args.verify:
        with open(os.path.join(args.verify, "manifest.json")) as fh:
            manifest = json.load(fh)
        split = manifest["name"].rsplit("_", 1)[-1]
        live = SyntheticDataset(get_imdb(args.base), split=split, num_images=manifest["num_images"])
        bad = 0
        for i in range(manifest["num_images"]):
            got = frame_digest(live.load_frame(i))
            if got != manifest["frames"][i]:
                print(f"frame {i}: MISMATCH {got[:12]} != {manifest['frames'][i][:12]}")
                bad += 1
        print(f"verified {manifest['num_images']} frames, {bad} mismatches")
        return 1 if bad else 0

    imdb = get_imdb(args.imdb)
    if not isinstance(imdb, SyntheticDataset) or args.num:
        imdb = SyntheticDataset(get_imdb(args.base), split="val", num_images=args.num or 64)
    out = args.out or f"data/{args.imdb}_v3"
    manifest = freeze_dataset(imdb, out)
    print(f"froze {manifest['num_images']} frames of {manifest['name']} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
