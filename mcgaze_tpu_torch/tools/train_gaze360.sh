#!/usr/bin/env bash
# Train the Gaze360 setting with the port, on one card (default) or, with
# --device cpu, on the CPU. Run from the repository root; extra arguments go
# to the train CLI. Several cards: dist_train.sh.
#
#   bash mcgaze_tpu_torch/tools/train_gaze360.sh [train args...]
PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
    python -m mcgaze_tpu_torch.tools.train \
    configs/multiclue_gaze/multiclue_gaze_r50_gaze360.py "$@"
