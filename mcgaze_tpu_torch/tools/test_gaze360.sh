#!/usr/bin/env bash
# Evaluate the Gaze360 setting with the port: per-video results JSON, then
# the MAE buckets. Run from the repository root; arguments after the
# checkpoint go to the eval CLI (e.g. --device cpu, --cfg-options ...).
#
#   bash mcgaze_tpu_torch/tools/test_gaze360.sh [ckpt.pth] [eval args...]
CKPT=${1:-ckpts/multiclue_gaze_r50_gaze360.pth}
export PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH
set -e
python -m mcgaze_tpu_torch.tools.test_gaze360_gaze \
    configs/multiclue_gaze/multiclue_gaze_r50_gaze360.py "$CKPT" \
    --json data/gaze360/test.json --root data/gaze360/test_rawframes/ \
    "${@:2}"
python -m mcgaze_tpu_torch.tools.calculate_mae_gaze360 \
    --evalfile results/results_multiclue_gaze_r50_gaze360_test.json \
    --anno data/gaze360/test.json
