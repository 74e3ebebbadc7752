"""The device mesh of a run, counterpart of mcgaze_tpu/parallel/mesh.py.

The JAX package runs one jitted step over a ('data', 'model') mesh. The
port runs one process per device, D x M processes for a mesh of D, M:

  * 'data': each data process loads its share of the global batch,
    DistributedDataParallel averages the gradients over the data axis in
    backward (NCCL on the card, gloo on the CPU), and the losses are
    normalised by global counts (parallel/distributed.py::
    global_normalizer), so the averaged gradient is that of the JAX
    single-program global loss;
  * 'model': tensor parallelism over TP_RULES, the JAX package's
    _TP_RULES on the port's reference names (parallel/tensor_parallel.py):
    the M processes of one model group hold one batch, every parameter
    the rules name as a contiguous 1/M slice, and every other parameter
    whole, with an all-reduce where a split product is summed.

Rank r sits at data index r // M and model index r % M: the model axis
varies fastest, as the JAX make_mesh reshapes its devices (D, M).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .distributed import (_active, process_count, process_index,
                          set_model_axis)

# (parameter name, dimension split over 'model', the layer's input arrives
# split), every other parameter replicated. torch's Linear weight is
# (out, in): dim 0 is the JAX kernel's output axis, dim 1 its input axis.
#   ffn.layers.0.0 (ffn_fc1): weight and bias along the FFN's width
#   ffn.layers.1   (ffn_fc2): weight along its input (fc1's split output),
#                             bias replicated
#   instance_interactive_conv.fc_layer: weight along its input (S*S*C),
#                             bias replicated
TP_RULES = (
    (re.compile(r'\.bbox_head\.\d+\.ffn\.layers\.0\.0\.(weight|bias)$'), 0,
     False),
    (re.compile(r'\.bbox_head\.\d+\.ffn\.layers\.1\.weight$'), 1, True),
    (re.compile(r'\.bbox_head\.\d+\.instance_interactive_conv\.fc_layer\.'
                r'weight$'), 1, False),
)


def tp_rule(name: str) -> Optional[Tuple[int, bool]]:
    """(split dimension, input arrives split) of the parameter `name`
    under TP_RULES, or None where it is replicated."""
    for rx, dim, split_input in TP_RULES:
        if rx.search(name):
            return dim, split_input
    return None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n_data x n_model processes, one device each. The groups are this
    process's along each axis (None: the default group, or no model
    axis)."""
    n_data: int
    n_model: int = 1
    data_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    @property
    def model_index(self) -> int:
        """This process's shard: which 1/n_model slice it holds."""
        return process_index() % self.n_model


def check_model_axis(n_model: int, model_cfg) -> None:
    """ValueError unless n_model divides every dimension TP_RULES split:
    the FFN's width and DynamicConv's fc_layer input, roi_size^2 x
    channels."""
    widths = dict(ffn_channels=model_cfg.ffn_channels,
                  fc_layer_input=model_cfg.roi_size ** 2
                  * model_cfg.channels)
    bad = {k: v for k, v in widths.items() if v % n_model}
    if n_model < 1 or bad:
        raise ValueError(f'a model axis of {n_model} must divide the widths '
                         f'it splits, {widths}; it does not divide {bad}')


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh over the running processes (n_data default:
    all of them over n_model). Each process drives one device, so n_data
    x n_model must be the number of processes. With n_model > 1 every
    process creates every group of both axes, in the same order (a
    process that skipped one would hang the others), and the data axis
    is recorded for parallel/distributed.py."""
    world = process_count()
    if n_model < 1:
        raise ValueError(f'a model axis of {n_model}')
    if n_data is None:
        n_data = max(world // n_model, 1)
    n = n_data * n_model
    if n != world:
        raise ValueError(
            f'a mesh of {n_data},{n_model} needs {n} processes, one device '
            f'each; {world} running (launch with torchrun --nproc-per-node '
            f'{n})')
    if n_model == 1:
        set_model_axis()
        return Mesh(n_data, 1)
    model_groups = [dist.new_group(list(range(d * n_model,
                                              (d + 1) * n_model)))
                    for d in range(n_data)]
    data_groups = [dist.new_group(list(range(m, world, n_model)))
                   for m in range(n_model)]
    rank = process_index()
    mesh = Mesh(n_data, n_model, data_group=data_groups[rank % n_model],
                model_group=model_groups[rank // n_model])
    set_model_axis(n_model, mesh.data_group)
    return mesh


def parse_mesh(spec: str | None) -> Mesh:
    """'D,M' (the CLIs' --mesh) or None (every process on the data axis)."""
    if spec is None:
        return make_mesh()
    n_data, n_model = (int(x) for x in spec.split(','))
    return make_mesh(n_data, n_model)


def wrap_model(model: nn.Module, device, mesh: Mesh | None = None
               ) -> nn.Module:
    """The model under DistributedDataParallel over the data axis when a
    process group is up, else the model itself. Under a model axis DDP
    runs on the data group alone: over the world its construction-time
    broadcast would give every rank rank 0's shards (of the same shapes),
    and its gradient average would mix different ranks' shards. With one
    data process there is nothing for it to do.

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
    group = None
    if mesh is not None and mesh.n_model > 1:
        if mesh.n_data == 1:
            return model
        group = mesh.data_group
    device = torch.device(device)
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index if device.index is not None
                           else torch.cuda.current_device()]
        if device.type == 'cuda' else None,
        find_unused_parameters=True, broadcast_buffers=False,
        process_group=group)
