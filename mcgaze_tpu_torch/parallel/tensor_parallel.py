"""Tensor parallelism over the mesh's 'model' axis (parallel/mesh.py::
TP_RULES), the port's counterpart of the JAX package's sharded params,
where XLA inserts the all-reduce on the contracting side.

Three autograd Functions move activations across the model group:
  * copy to the model region   forward identity, backward all-reduce
  * reduce from it             forward all-reduce, backward identity
  * scatter to it              forward this rank's contiguous slice of the
                               last dim, backward all-gather
and two layers stand in for models/layers.py::Linear, computing in the
input's dtype with f32 parameters as it does:
  * ColumnParallelLinear: weight (out/M, in) and bias (out/M); its output
    stays split (the FFN's fc1, whose split output the ReLU and fc2 use);
  * RowParallelLinear: weight (out, in/M), bias (out) replicated; the
    partial products are all-reduced, then the bias added once (the FFN's
    fc2, whose input arrives split, and DynamicConv's fc_layer, which
    scatters its full input).

`shard_model` swaps them in where TP_RULES name a weight, holding this
rank's slice of the full seeded weights, so every shard is a slice of the
one-process model. `gather_state_dict` is the collective inverse: the
full, reference-named tensors, for checkpoints and the validation's full
model. Only all_reduce and all_gather run on the model group.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import Mesh, tp_rule


def _all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, parts):
        ctx.group = group
        width = x.shape[-1] // parts
        return x[..., rank * width:(rank + 1) * width].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather_cat(g, -1, ctx.group), None, None, None


class ColumnParallelLinear(nn.Module):
    """y_local = x W_local^T + b_local: this rank's out/M outputs."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 mesh: Mesh):
        super().__init__()
        self.group = mesh.model_group
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x):
        x = _CopyToModel.apply(x, self.group)
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None
                        else self.bias.to(x.dtype))


class RowParallelLinear(nn.Module):
    """y = sum over the model group of x_local W_local^T, then + b. With
    split_input=False the layer takes the full input and keeps its own
    slice of it."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 mesh: Mesh, split_input: bool):
        super().__init__()
        self.group = mesh.model_group
        self.rank, self.parts = mesh.model_index, mesh.n_model
        self.split_input = split_input
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x):
        if not self.split_input:
            x = _ScatterToModel.apply(x, self.group, self.rank, self.parts)
        y = _ReduceFromModel.apply(F.linear(x, self.weight.to(x.dtype)),
                                   self.group)
        return y if self.bias is None else y + self.bias.to(x.dtype)


def shard_tensor(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous 1/M slice of `t` along `dim` (a copy)."""
    if t.shape[dim] % mesh.n_model:
        raise ValueError(f'a model axis of {mesh.n_model} does not divide '
                         f'dimension {dim} of a {tuple(t.shape)} tensor')
    return t.chunk(mesh.n_model, dim)[mesh.model_index].clone()


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """In place: every Linear whose weight TP_RULES name becomes a
    ColumnParallelLinear (split along its outputs) or a RowParallelLinear
    (along its inputs) holding this rank's slice of the full weights. The
    model keeps its parameter names; only the shapes of the split ones
    change. No-op for a model axis of 1. A model-parallel model is a
    training model: its eval forward and checkpoints take the full
    weights of gather_state_dict."""
    if mesh.n_model == 1:
        return model
    swaps = []
    for name, module in model.named_modules():
        rule = tp_rule(f'{name}.weight')
        if rule is None or not isinstance(module, nn.Linear):
            continue
        dim, split_input = rule
        with torch.no_grad():
            weight = shard_tensor(module.weight.detach(), dim, mesh)
            bias = module.bias
            if bias is not None:
                bias = (shard_tensor(bias.detach(), 0, mesh) if dim == 0
                        else bias.detach().clone())
        layer = (ColumnParallelLinear(weight, bias, mesh) if dim == 0 else
                 RowParallelLinear(weight, bias, mesh, split_input))
        swaps.append((name, layer.train(module.training)))
    for name, layer in swaps:
        parent, _, child = name.rpartition('.')
        setattr(model.get_submodule(parent), child, layer)
    return model


def _named(tensors) -> Dict[str, torch.Tensor]:
    return (tensors.state_dict() if isinstance(tensors, nn.Module)
            else tensors)


def gather_state_dict(tensors, mesh: Optional[Mesh]) -> dict:
    """The full tensors by reference name: a module's state dict or a
    {parameter name: tensor} dict (the EMA copy, the AdamW moments), each
    tensor TP_RULES split all-gathered over the model group, the others as
    they are. A collective: every rank of the model group calls it."""
    named = _named(tensors)
    if mesh is None or mesh.n_model == 1:
        return dict(named)
    out = {}
    for name, t in named.items():
        rule = tp_rule(name)
        out[name] = (t if rule is None else
                     _all_gather_cat(t.detach(), rule[0], mesh.model_group))
    return out


def shard_state_dict(full: dict, mesh: Optional[Mesh]) -> dict:
    """The inverse of gather_state_dict on this rank: each tensor TP_RULES
    split sliced to this rank's part; no collective."""
    if mesh is None or mesh.n_model == 1:
        return full
    return {name: (t if tp_rule(name) is None
                   else shard_tensor(t, tp_rule(name)[0], mesh))
            for name, t in full.items()}
