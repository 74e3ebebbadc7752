#!/usr/bin/env bash
# Train the l2cs setting with the port (see train_gaze360.sh).
#
#   bash mcgaze_tpu_torch/tools/train_l2cs.sh [train args...]
PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
    python -m mcgaze_tpu_torch.tools.train \
    configs/multiclue_gaze/multiclue_gaze_r50_l2cs.py "$@"
