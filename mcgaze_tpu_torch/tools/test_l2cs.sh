#!/usr/bin/env bash
# Evaluate the l2cs setting with the port (see test_gaze360.sh).
#
#   bash mcgaze_tpu_torch/tools/test_l2cs.sh [ckpt.pth] [eval args...]
CKPT=${1:-ckpts/multiclue_gaze_r50_l2cs.pth}
export PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH
set -e
python -m mcgaze_tpu_torch.tools.test_gaze360_gaze \
    configs/multiclue_gaze/multiclue_gaze_r50_l2cs.py "$CKPT" \
    --json data/l2cs/test.json --root data/l2cs/test_rawframes/ "${@:2}"
python -m mcgaze_tpu_torch.tools.calculate_mae_l2cs \
    --evalfile results/results_multiclue_gaze_r50_l2cs_test.json \
    --anno data/l2cs/test.json
