"""Config loading for the query-detector family (InstBlink), counterpart of
mcgaze_tpu/utils/query_config.py:
  1. native configs assigning QueryDetectorConfig / InstBlinkDataConfig /
     InstBlinkEvalConfig / OptimConfig (configs/instblink/), their
     `mcgaze_tpu.*` imports resolved to the port's dataclasses
     (utils/config.py::PORTED_CONFIG_MODULES);
  2. the reference's legacy dataset configs
     (configs/_base_/datasets/mpeblink.py and the like): the reference ships
     no assembled model config for this family, so a legacy file gives the
     data pipeline (clip_length, img_scale, samples_per_gpu, paths), merged
     onto the model's defaults.
"""
from __future__ import annotations

import dataclasses

from ..data.instblink_dataset import InstBlinkDataConfig
from ..evaluation.instblink_driver import InstBlinkEvalConfig
from ..models.query_detector import QueryDetectorConfig
from ..train.loop import OptimConfig
from .config import _exec_pyfile, load_legacy_dict


@dataclasses.dataclass
class QueryConfig:
    model: QueryDetectorConfig
    optim: OptimConfig
    data_train: InstBlinkDataConfig
    data_test: InstBlinkDataConfig
    eval_cfg: InstBlinkEvalConfig
    work_dir: str = './work_dirs/instblink'
    checkpoint_interval: int = 1000
    log_interval: int = 50
    seed: int = 0


def _canvas(scale):
    """(h, w) canvas of an img_scale (long, short), each padded to /32."""
    long, short = max(scale), min(scale)
    return ((short + 31) // 32 * 32, (long + 31) // 32 * 32)


def _translate_legacy(ns: dict) -> QueryConfig:
    """A legacy mpeblink/youtubevis dataset config -> QueryConfig with the
    model's defaults."""
    data_d = ns.get('data', {})
    clip_length = ns.get('clip_length', 11)
    dataset_type = data_d.get('train', {}).get(
        'type', ns.get('dataset_type', 'MPEblinkDataset'))
    with_blinks = 'blink' in dataset_type.lower() or \
        'MPEblink' in dataset_type
    blink_sampled = 'Sampled' in dataset_type

    def pipeline_params(pipeline):
        scale, flip, keep = (640, 360), None, True
        for step in pipeline or []:
            if step.get('type') == 'Resize':
                s = step.get('img_scale', (640, 360))
                if isinstance(s, list):
                    s = s[0]
                scale = tuple(s)
                keep = step.get('keep_ratio', True)
            elif step.get('type') == 'RandomFlip':
                flip = step.get('flip_ratio') or 0.0
        return scale, flip, keep

    def data_cfg(split, default_flip):
        d = data_d.get(split, {})
        scale, flip, keep = pipeline_params(d.get('pipeline'))
        return InstBlinkDataConfig(
            ann_file=d.get('ann_file', ''),
            img_prefix=d.get('img_prefix', ''),
            clip_length=d.get('clip_length', clip_length),
            scale=scale, canvas=_canvas(scale),
            flip_ratio=default_flip if flip is None else flip,
            batch_size=data_d.get('samples_per_gpu', 4),
            with_blinks=with_blinks,
            blink_sampled=blink_sampled and split == 'train',
            keep_ratio=keep,
        )

    dtr = data_cfg('train', 0.5)
    dte = data_cfg('test', 0.0)
    model = QueryDetectorConfig(clip_length=dtr.clip_length,
                                num_classes=1 if with_blinks else 40,
                                with_blink=with_blinks)
    return QueryConfig(
        model=model, optim=OptimConfig(max_iters=12000, lr_steps=(8000,)),
        data_train=dtr, data_test=dte,
        eval_cfg=InstBlinkEvalConfig(clip_length=dte.clip_length),
        work_dir=ns.get('work_dir', './work_dirs/instblink'))


def load_query_config(path: str) -> QueryConfig:
    ns = _exec_pyfile(path)
    if isinstance(ns.get('model'), QueryDetectorConfig):
        return QueryConfig(
            model=ns['model'],
            optim=ns.get('optim', OptimConfig()),
            data_train=ns.get('data_train', InstBlinkDataConfig()),
            data_test=ns.get('data_test', InstBlinkDataConfig()),
            eval_cfg=ns.get('eval_cfg', InstBlinkEvalConfig()),
            work_dir=ns.get('work_dir', './work_dirs/instblink'),
            checkpoint_interval=ns.get('checkpoint_interval', 1000),
            log_interval=ns.get('log_interval', 50),
            seed=ns.get('seed', 0),
        )
    return _translate_legacy(load_legacy_dict(path, ns))
