#!/usr/bin/env bash
# Data-parallel training with the port: torchrun starts one process per
# card (NCCL; gloo with --device cpu), each loading its share of the
# config's global batch (tools/train.py). Several hosts: the same command on
# each, with NNODES, NODE_RANK and MASTER_ADDR (host 0) set.
#
#   NPROC_PER_NODE=4 bash mcgaze_tpu_torch/tools/dist_train.sh <config> \
#       [train args...]
# NPROC_PER_NODE defaults to the number of cards nvidia-smi lists.
CONFIG=$1
NPROC=${NPROC_PER_NODE:-$(nvidia-smi -L | wc -l)}
PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
    torchrun --nproc-per-node "$NPROC" --nnodes "${NNODES:-1}" \
    --node-rank "${NODE_RANK:-0}" --master-addr "${MASTER_ADDR:-127.0.0.1}" \
    --master-port "${MASTER_PORT:-29500}" \
    -m mcgaze_tpu_torch.tools.train "$CONFIG" --seed 0 "${@:2}"
