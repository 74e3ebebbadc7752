"""Config loading, counterpart of mcgaze_tpu/utils/config.py.

Two surfaces:
  1. Native configs: Python files assigning `model` / `optim` /
     `data_train` / `data_test` / `eval_cfg` dataclasses
     (configs/multiclue_gaze/; the query family's, configs/instblink/,
     load through utils/query_config.py).
  2. Legacy mmdet-style dict configs (the reference's format, `_base_`
     inheritance and `_delete_`), parsed and translated.

The shipped native configs import their dataclasses from the JAX package
(`from mcgaze_tpu.models.mcgaze import ModelConfig`, ...). The loader runs
a config file with those imports (PORTED_CONFIG_MODULES) resolved to the
port's own dataclasses and refuses any other import of the JAX package, so
it never imports it.
"""
from __future__ import annotations

import builtins
import dataclasses
import importlib
import os.path as osp
import types
from typing import Optional

from ..data.dataset import DataConfig
from ..evaluation.driver import EvalConfig
from ..models.mcgaze import ModelConfig
from ..train.loop import OptimConfig

# the JAX package's modules a config file may import from, and the port's
# module that holds the same dataclasses
PORTED_CONFIG_MODULES = {
    'mcgaze_tpu.data.dataset': 'mcgaze_tpu_torch.data.dataset',
    'mcgaze_tpu.data.instblink_dataset':
        'mcgaze_tpu_torch.data.instblink_dataset',
    'mcgaze_tpu.evaluation.driver': 'mcgaze_tpu_torch.evaluation.driver',
    'mcgaze_tpu.evaluation.instblink_driver':
        'mcgaze_tpu_torch.evaluation.instblink_driver',
    'mcgaze_tpu.models.mcgaze': 'mcgaze_tpu_torch.models.mcgaze',
    'mcgaze_tpu.models.query_detector':
        'mcgaze_tpu_torch.models.query_detector',
    'mcgaze_tpu.train.loop': 'mcgaze_tpu_torch.train.loop',
}


def _config_import(name, globals=None, locals=None, fromlist=(), level=0):
    """__import__ for config files: `from mcgaze_tpu.<m> import X` of a
    module in PORTED_CONFIG_MODULES yields the port's module; any other
    import of mcgaze_tpu raises; everything else imports as usual."""
    if level == 0 and name.split('.')[0] == 'mcgaze_tpu':
        if name not in PORTED_CONFIG_MODULES or not fromlist:
            raise ImportError(
                f'config imports {name!r}: the port resolves only '
                f'`from <m> import ...` of {sorted(PORTED_CONFIG_MODULES)} '
                'and never imports the JAX package')
        return importlib.import_module(PORTED_CONFIG_MODULES[name])
    return builtins.__import__(name, globals, locals, fromlist, level)


@dataclasses.dataclass
class Config:
    model: ModelConfig
    optim: OptimConfig
    data_train: DataConfig
    data_test: DataConfig
    eval_cfg: EvalConfig
    work_dir: str = './work_dirs/default'
    checkpoint_interval: int = 1000
    log_interval: int = 50
    seed: int = 0


def _exec_pyfile(path: str) -> dict:
    with open(path) as f:
        code = f.read()
    module = types.ModuleType('cfg')
    module.__dict__['__file__'] = path
    module.__dict__['__builtins__'] = dict(vars(builtins),
                                           __import__=_config_import)
    exec(compile(code, path, 'exec'), module.__dict__)
    return {k: v for k, v in module.__dict__.items()
            if not k.startswith('__')}


def _merge_dict(base: dict, override: dict) -> dict:
    """mmcv-style recursive merge with `_delete_` support."""
    out = dict(base)
    for k, v in override.items():
        if (isinstance(v, dict) and isinstance(out.get(k), dict)
                and not v.pop('_delete_', False)):
            out[k] = _merge_dict(out[k], v)
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != '_delete_'}
            out[k] = v
    return out


def load_legacy_dict(path: str, ns: Optional[dict] = None) -> dict:
    """Resolve a legacy config file with `_base_` inheritance.

    `ns` lets a caller that already executed the file pass its namespace
    in (load_config probes the file once for the native format, then
    resolves it as legacy without re-running its module body)."""
    ns = dict(ns) if ns is not None else _exec_pyfile(path)
    bases = ns.pop('_base_', [])
    if isinstance(bases, str):
        bases = [bases]
    merged: dict = {}
    for b in bases:
        merged = _merge_dict(merged, load_legacy_dict(
            osp.join(osp.dirname(path), b)))
    return _merge_dict(merged, ns)


_GAZE_LOSS_TYPES = {'GazeArccosLoss': 'arccos', 'GazeCosLoss': 'cos',
                    'GazePinballLoss': 'pinball'}


def _gaze_loss_type(legacy_type: str) -> str:
    try:
        return _GAZE_LOSS_TYPES[legacy_type]
    except KeyError:
        raise ValueError(
            f'unsupported gaze_head loss_gaze type {legacy_type!r}; '
            f'supported: {sorted(_GAZE_LOSS_TYPES)} '
            '(reference mmdet/models/losses/__init__.py:21-24)') from None


def _translate_legacy(ns: dict) -> Config:
    """Map the reference's config keys onto native dataclasses."""
    model_d = ns.get('model', {})
    roi = model_d.get('roi_head', {})
    bbox_heads = roi.get('bbox_head', [{}])
    bh = bbox_heads[0] if isinstance(bbox_heads, list) else bbox_heads
    gaze_heads = roi.get('gaze_head', [{}])
    gh = gaze_heads[0] if isinstance(gaze_heads, list) else gaze_heads

    clip_length = ns.get('clip_length', 7)
    num_stages = roi.get('num_stages', ns.get('num_stages', 4))
    model = ModelConfig(
        backbone_depth=model_d.get('backbone', {}).get('depth', 50),
        num_stages=num_stages,
        clip_length=clip_length,
        ffn_channels=bh.get('feedforward_channels', 2048),
        num_heads=bh.get('num_heads', 8),
        num_cls_fcs=bh.get('num_cls_fcs', 1),
        num_reg_fcs=bh.get('num_reg_fcs', 3),
        loss_cls_weight=bh.get('loss_cls', {}).get('loss_weight', 2.0),
        loss_bbox_weight=bh.get('loss_bbox', {}).get('loss_weight', 5.0),
        loss_iou_weight=bh.get('loss_iou', {}).get('loss_weight', 2.0),
        focal_gamma=bh.get('loss_cls', {}).get('gamma', 2.0),
        focal_alpha=bh.get('loss_cls', {}).get('alpha', 0.25),
        loss_gaze_weight=gh.get('loss_gaze', {}).get('loss_weight', 6.0),
        loss_temp_weight=gh.get('loss_temp', {}).get('loss_weight', 1.0),
        gaze_loss_type=_gaze_loss_type(
            gh.get('loss_gaze', {}).get('type', 'GazeArccosLoss')),
        stage_loss_weights=tuple(
            roi.get('stage_loss_weights', [1.0] * num_stages)),
    )

    opt_d = ns.get('optimizer', {})
    lr_d = ns.get('lr_config', {})
    runner = ns.get('runner', {})
    bb_mult = (opt_d.get('paramwise_cfg', {}).get('custom_keys', {})
               .get('backbone', {}).get('lr_mult', 0.1))
    optim = OptimConfig(
        lr=opt_d.get('lr', 1e-3),
        weight_decay=opt_d.get('weight_decay', 1e-4),
        backbone_lr_mult=bb_mult,
        grad_clip_norm=(ns.get('optimizer_config', {}).get('grad_clip')
                        or {}).get('max_norm', 0.1),
        warmup_iters=lr_d.get('warmup_iters', 1000),
        warmup_ratio=lr_d.get('warmup_ratio', 0.001),
        lr_steps=tuple(lr_d.get('step', [6000])),
        max_iters=runner.get('max_iters', 7000),
    )

    data_d = ns.get('data', {})

    def pipeline_params(pipeline):
        """Returns (crop, scale, flip); flip is None when the pipeline has
        no RandomFlip step (caller applies the split default), and the
        explicit value — including 0.0 — when it does."""
        crop, scale = None, (224, 224)
        flip = None
        for step in pipeline or []:
            if step.get('type') == 'CenterCrop':
                crop = step.get('crop_size', (0.68, 0.68))[0]
            elif step.get('type') == 'Resize':
                scale = tuple(step.get('img_scale', (224, 224)))
            elif step.get('type') == 'RandomFlip':
                # mmdet treats flip_ratio=None as "never flip"
                flip = step.get('flip_ratio') or 0.0
        return crop, scale, flip

    def data_cfg(split, default_flip):
        d = data_d.get(split, {})
        crop, scale, flip = pipeline_params(d.get('pipeline'))
        canvas = (max(scale), max(scale))
        return DataConfig(
            ann_file=d.get('ann_file', ''),
            img_prefix=d.get('img_prefix', ''),
            clip_length=d.get('clip_length', clip_length),
            scale=scale, canvas=canvas, crop_size=crop,
            flip_ratio=default_flip if flip is None else flip,
            batch_size=data_d.get('samples_per_gpu', 32),
        )

    dtr = data_cfg('train', 0.5)
    dte = data_cfg('test', 0.0)
    crop_ratio = (None if dte.crop_size is None
                  else (dte.crop_size + 1.0) / 2.0)
    eval_cfg = EvalConfig(clip_length=clip_length, scale=dte.scale,
                          canvas=dte.canvas, crop_ratio=crop_ratio,
                          crop_size=dte.crop_size
                          if dte.crop_size is not None else 0.68)
    return Config(model=model, optim=optim, data_train=dtr, data_test=dte,
                  eval_cfg=eval_cfg,
                  work_dir=ns.get('work_dir', './work_dirs/default'),
                  checkpoint_interval=ns.get('checkpoint_config', {})
                  .get('interval', 1000))


def load_config(path: str) -> Config:
    ns = _exec_pyfile(path)
    if isinstance(ns.get('model'), ModelConfig):
        return Config(
            model=ns['model'],
            optim=ns.get('optim', OptimConfig()),
            data_train=ns.get('data_train', DataConfig()),
            data_test=ns.get('data_test', DataConfig()),
            eval_cfg=ns.get('eval_cfg', EvalConfig()),
            work_dir=ns.get('work_dir', './work_dirs/default'),
            checkpoint_interval=ns.get('checkpoint_interval', 1000),
            log_interval=ns.get('log_interval', 50),
            seed=ns.get('seed', 0),
        )
    # legacy mmdet-style dict config (re-using the namespace executed
    # above — a config file's module body runs exactly once)
    return _translate_legacy(load_legacy_dict(path, ns))
