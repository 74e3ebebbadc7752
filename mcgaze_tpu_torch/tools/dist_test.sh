#!/usr/bin/env bash
# Data-parallel evaluation with the port: torchrun starts one process per
# card, the videos are sharded over the ranks and rank 0 gathers and writes
# the results (tools/test_gaze360_gaze.py). Several hosts: as dist_train.sh.
#
#   NPROC_PER_NODE=4 bash mcgaze_tpu_torch/tools/dist_test.sh <config> \
#       <ckpt.pth> [eval args...]
CONFIG=$1
CKPT=$2
NPROC=${NPROC_PER_NODE:-$(nvidia-smi -L | wc -l)}
PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
    torchrun --nproc-per-node "$NPROC" --nnodes "${NNODES:-1}" \
    --node-rank "${NODE_RANK:-0}" --master-addr "${MASTER_ADDR:-127.0.0.1}" \
    --master-port "${MASTER_PORT:-29500}" \
    -m mcgaze_tpu_torch.tools.test_gaze360_gaze "$CONFIG" "$CKPT" "${@:3}"
