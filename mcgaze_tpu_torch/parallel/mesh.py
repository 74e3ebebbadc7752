"""The device mesh of a run, counterpart of mcgaze_tpu/parallel/mesh.py.

The JAX package runs one jitted step over a ('data', 'model') mesh. The
port runs one process per device and covers the 'data' axis alone: each
process holds a whole model, DistributedDataParallel averages the
gradients over the processes in backward (NCCL on the card, gloo on the
CPU), and the losses are normalised by global counts
(parallel/distributed.py::global_normalizer), so the averaged gradient is
that of the JAX single-program global loss. The 'model' axis (tensor
parallelism over the JAX package's _TP_RULES) is not ported.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .distributed import _active, process_count

TENSOR_PARALLEL = ('ROADMAP Queue 1, item 12b (the tensor-parallel model '
                   'axis over _TP_RULES)')


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n_data processes, one device each, on the 'data' axis."""
    n_data: int
    n_model: int = 1


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The data axis over the running processes (default: all of them).
    n_model > 1 raises NotImplementedError; n_data must be the number of
    processes, since each process drives one device."""
    if n_model != 1:
        raise NotImplementedError(
            f'a model axis of {n_model} is not ported: {TENSOR_PARALLEL}')
    world = process_count()
    if n_data is None:
        n_data = world
    if n_data != world:
        raise ValueError(
            f'a data axis of {n_data} needs {n_data} processes, one device '
            f'each; {world} running (launch with torchrun '
            f'--nproc-per-node {n_data})')
    return Mesh(n_data, n_model)


def parse_mesh(spec: str | None) -> Mesh:
    """'D,M' (the CLIs' --mesh) or None (every process on the data axis)."""
    if spec is None:
        return make_mesh()
    n_data, n_model = (int(x) for x in spec.split(','))
    return make_mesh(n_data, n_model)


def wrap_model(model: nn.Module, device) -> nn.Module:
    """The model under DistributedDataParallel when a process group is up,
    else the model itself.

    find_unused_parameters=True: which parameters get no gradient depends
    on the configuration (the learned proposal boxes reach the loss only
    through detached boxes in every model; blink_reference_semantics leaves
    the blink tower unused), and DDP would otherwise wait for them and
    fail. static_graph would also cover them, but fixes the graph it
    records at the first step; finding them costs one graph walk a step.
    broadcast_buffers=False: the only buffers are FrozenBN statistics,
    identical on every process and never updated."""
    if not _active():
        return model
    device = torch.device(device)
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index if device.index is not None
                           else torch.cuda.current_device()]
        if device.type == 'cuda' else None,
        find_unused_parameters=True, broadcast_buffers=False)
