#!/bin/bash
# The evaluation battery of one snapshot on the card, over the PyTorch port
# (the port of tools/eval_checkpoint.sh):
#   test_net on lov_syn_val with ICP and the prediction overlays (--vis),
#   diag_rot on lov_syn_val and on lov_syn_val_v4 (the frozen sets in the
#   repository; lov_syn_train needs the YCB meshes), analyze_z on the
#   detections, and with --ab the point-to-plane ICP run (weight 1.0).
#
# Usage: posecnn_torch/tools/eval_checkpoint.sh SNAPSHOT.npz OUT_DIR [--ab]
# (DEVICE=cpu in the environment runs it on the CPU; default cuda)
set -e
CKPT="$(realpath "$1")"; OUT="$(realpath -m "$2")"; AB="$3"
DEVICE="${DEVICE:-cuda}"
CFG=experiments/cfgs/lov_syn_refresh.yml
cd "$(dirname "$0")/../.."

python -m posecnn_torch.test_net --cfg "$CFG" --imdb lov_syn_val \
    --model "$CKPT" --output "$OUT" --vis --device "$DEVICE"
python -m posecnn_torch.tools.diag_rot --model "$CKPT" --imdb lov_syn_val \
    --frames 16 --out "$OUT/diag_rot_val.json" --device "$DEVICE"
python -m posecnn_torch.tools.diag_rot --model "$CKPT" --imdb lov_syn_val_v4 \
    --frames 16 --out "$OUT/diag_rot_v4.json" --device "$DEVICE"
python tools/analyze_z.py --dets "$OUT/detections.npz" \
    --out "$OUT/z_analysis.json"

if [ "$AB" = "--ab" ]; then
    # ICP energy A/B: point-to-point (the cfg's) against + point-to-plane;
    # the same detections, refinement only
    python -m posecnn_torch.test_net --cfg "$CFG" --imdb lov_syn_val \
        --model "$CKPT" --output "${OUT}_p2plane" --icp_plane_weight 1.0 --device "$DEVICE"
fi

python - "$OUT" <<'PY'
import json, sys
d = json.load(open(f"{sys.argv[1]}/eval_summary.json"))
print({k: round(v, 4) for k, v in d.items() if isinstance(v, (int, float))})
for tag in ("val", "v4"):
    r = json.load(open(f"{sys.argv[1]}/diag_rot_{tag}.json"))
    print(tag, {k: (round(v, 3) if v is not None else None) for k, v in r["pred_hough"].items()})
PY
