"""Weights across packages: the JAX variables tree -> the port's state dict.

`jax_variables_to_state_dict` is the exact inverse of
mcgaze_tpu/utils/torch_convert.py::convert_mcgaze_checkpoint_dict, and
`jax_query_variables_to_state_dict` of convert_query_checkpoint_dict (the
InstBlink query detector: the same rules plus its blink heads). Each takes
the JAX `{'params', 'stats'}` tree as nested dicts of numpy arrays and
returns the reference mmdet names the port's modules use:
  * flax Conv kernel (H, W, I, O)  -> Conv weight (O, I, H, W)
  * flax Dense kernel (in, out)    -> Linear weight (out, in)
  * attention/qkv                  -> attention.attn.in_proj_{weight,bias}
  * FrozenBatchNorm scale/bias + stats mean/var
                                   -> weight/bias/running_mean/running_var
The TeViT MsgShifT backbone's tree (backbone/patch_embed{i}, stage{i}_layer
{l}, stage{i}_norm, msg_tokens) maps to the reference's `layers.{i}.0`,
`layers.{i}.1.{l}` (attn.attn packed in_proj, attn.sr, attn.norm,
ffn.layers.{0,1,4}), `layers.{i}.2` and `msg_tokens`, the inverse of
convert_msgshift_backbone.
`clean_reference_state_dict` and `clean_reference_query_state_dict` prepare
a reference .pth's state dict for `load_state_dict(strict=True)`.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# module-path rewrites, JAX tree path (with '/') -> reference name, in order
_RULES = (
    # MsgShifT (TeViT)
    (r'^backbone/patch_embed(\d+)/proj$', r'backbone/layers/\1/0/projection'),
    (r'^backbone/patch_embed(\d+)/norm$', r'backbone/layers/\1/0/norm'),
    (r'^backbone/stage(\d+)_layer(\d+)/', r'backbone/layers/\1/1/\2/'),
    (r'^backbone/stage(\d+)_norm$', r'backbone/layers/\1/2'),
    (r'/attn/attn/out$', r'/attn/attn/out_proj'),
    (r'/attn/sr_norm$', r'/attn/norm'),
    (r'/ffn/fc1$', r'/ffn/layers/0'),
    (r'/ffn/dw$', r'/ffn/layers/1'),
    (r'/ffn/fc2$', r'/ffn/layers/4'),
    (r'^bbox_head_(\d+)/', r'roi_head.bbox_head.\1/'),
    (r'^gaze_head_(\d+)/', r'roi_head.gaze_head.\1/'),
    (r'^blink_head_(\d+)/', r'roi_head.blink_head.\1/'),
    (r'^init_proposal_(bboxes|features)$', r'rpn_head.init_proposal_\1'),
    (r'/layer(\d)_(\d+)/', r'/layer\1/\2/'),
    (r'/downsample_conv$', r'/downsample/0'),
    (r'/downsample_bn$', r'/downsample/1'),
    (r'^neck/lateral_(\d)$', r'neck/lateral_convs/\1/conv'),
    (r'^neck/fpn_(\d)$', r'neck/fpn_convs/\1/conv'),
    (r'/attention/out$', r'/attention/attn/out_proj'),
    (r'/iic_norm$', r'/instance_interactive_conv_norm'),
    (r'/ffn_fc1$', r'/ffn/layers/0/0'),
    (r'/ffn_fc2$', r'/ffn/layers/1'),
    (r'/cls_tower/', r'/cls_fcs/'),
    (r'/reg_tower/', r'/reg_fcs/'),
    (r'/blink_tower/', r'/blink_fcs/'),
)
# tower layers: fc{i} -> {3i}, ln{i} -> {3i+1}
_TOWER = re.compile(r'/(cls_fcs|reg_fcs|blink_fcs|gaze_\w+_fcs'
                    r'|gaze_\w+_confidence)/(fc|ln)(\d+)$')


def _flatten(tree, prefix=''):
    for k, v in tree.items():
        path = f'{prefix}/{k}' if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def _module_name(path: str) -> str:
    for pat, rep in _RULES:
        path = re.sub(pat, rep, path)
    m = _TOWER.search(path)
    if m:
        idx = 3 * int(m.group(3)) + (m.group(2) == 'ln')
        path = path[:m.start()] + f'/{m.group(1)}/{idx}'
    return path.replace('/', '.')


def jax_variables_to_state_dict(variables: dict) -> dict:
    """JAX MCGazeModel variables (numpy leaves) -> {name: torch.Tensor}
    under the reference names, loadable into the port's MCGazeModel with
    strict=True."""
    sd = {}
    for path, v in _flatten(variables['params']):
        if path.startswith('init_proposal_'):
            sd[_module_name(path) + '.weight'] = v
            continue
        module, leaf = path.rsplit('/', 1)
        if leaf == 'msg_tokens':
            sd[f'{module}.msg_tokens'] = v
            continue
        if module.endswith(('/attention/qkv', '/attn/attn/qkv')):
            # the gaze heads' attention brick holds its packed projection
            # one level down (attention.attn), MsgShifT's CrossMHA directly
            name = _module_name(module[:-len('/qkv')]) + (
                '.attn.in_proj_' if module.endswith('/attention/qkv')
                else '.in_proj_')
            sd[name + ('weight' if leaf == 'kernel' else 'bias')] = \
                v.T if leaf == 'kernel' else v
            continue
        name = _module_name(module)
        if leaf == 'kernel':
            sd[name + '.weight'] = (np.transpose(v, (3, 2, 0, 1))
                                    if v.ndim == 4 else v.T)
        elif leaf == 'scale':
            sd[name + '.weight'] = v
        elif leaf == 'bias':
            sd[name + '.bias'] = v
        else:
            raise KeyError(f'unexpected JAX param leaf {path}')
    for path, v in _flatten(variables.get('stats', {})):
        module, leaf = path.rsplit('/', 1)
        stat = {'mean': 'running_mean', 'var': 'running_var'}[leaf]
        sd[f'{_module_name(module)}.{stat}'] = v
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


# The query detector's tree uses the same module names plus blink_head_{s}
# (blink_tower -> blink_fcs) and, for TeViT, the MsgShifT backbone, which
# the rules above cover.
jax_query_variables_to_state_dict = jax_variables_to_state_dict


def _benign(key: str) -> bool:
    """Reference keys the port has no slot for, by design: BN bookkeeping
    and BBoxHead's dead default heads (the same set torch_convert.py
    tolerates)."""
    return (key.endswith('num_batches_tracked')
            or (key.startswith('roi_head.bbox_head.')
                and ('.fc_cls.' in key or '.fc_reg.' in key)))


def clean_reference_state_dict(sd: dict) -> dict:
    """A reference checkpoint's state dict ('state_dict' entry already
    taken) -> tensors the port loads with strict=True: strips a 'module.'
    prefix and drops only the benign keys."""
    out = {}
    for k, v in sd.items():
        k = k[len('module.'):] if k.startswith('module.') else k
        if not _benign(k):
            out[k] = torch.as_tensor(v)
    return out


def clean_reference_query_state_dict(sd: dict) -> dict:
    """A reference InstBlink checkpoint's state dict -> tensors the port's
    QueryDetector loads with strict=True: strips a 'module.' prefix, renames
    the pre-rewrite 'mask_head' to 'blink_head' (as init_detector does on
    load) and drops the BN bookkeeping. fc_cls / fc_reg are this model's
    heads, so nothing else is dropped."""
    out = {}
    for k, v in sd.items():
        k = k[len('module.'):] if k.startswith('module.') else k
        if not k.endswith('num_batches_tracked'):
            out[k.replace('mask_head', 'blink_head')] = torch.as_tensor(v)
    return out
