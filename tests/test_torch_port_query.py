"""The port's InstBlink query detector against the JAX package's, on the CPU.

Tiny configuration (R-50 at 64x96, 2 stages, 10 queries, 2 classes, C=32:
the size of tests/test_query_detector.py), seeded random weights on both
sides (the JAX tree carried across by jax_query_variables_to_state_dict),
the same numpy inputs. Tolerances:
  * GenericSTQIHead and BlinkHead (both semantics): 2e-5 (a few layers in
    f32, summed in another order);
  * QueryDetector per stage, cls_logits, boxes (relative to their largest
    coordinate) and blink_logits: 1e-3 (the model parity tolerance: f32
    through ~60 layers, roi_impl='mm');
  * topk_tracks and topk_tracks_batched: the same indices, values at 1e-5;
    ties go to the lower index, as lax.top_k breaks them.
Also the weights across packages: the reference-named .pth of
tests/test_query_convert.py loads natively with strict=True and through
the JAX converter to the same tensors, both ways; a blink tower with
biases is refused by both. And the config loader on the InstBlink config
and a legacy MPEblink dataset config, field for field.
"""
import dataclasses
import os.path as osp
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcgaze_tpu.models import query_detector as jq
from mcgaze_tpu.utils.torch_convert import convert_query_torch_checkpoint
from mcgaze_tpu_torch.models import query_detector as pq
from mcgaze_tpu_torch.utils.convert import (clean_reference_query_state_dict,
                                            jax_query_variables_to_state_dict)
from tests.test_query_convert import CFG as CONVERT_CFG
from tests.test_query_convert import query_state_dict
from tests.test_torch_port_model import random_variables, to_numpy_tree
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
INSTBLINK_CFG = osp.join(ROOT, 'configs/instblink/instblink_r50_mpeblink.py')
TINY = dict(num_stages=2, clip_length=3, num_queries=10, num_classes=2,
            channels=32, ffn_channels=64, num_heads=4, dyn_feat_channels=16,
            max_per_img=4, max_instances=3, roi_impl='mm')
H, W = 64, 96
B = 2


def port_model(variables, **overrides):
    model = pq.QueryDetector(pq.QueryDetectorConfig(**TINY, **overrides))
    model.load_state_dict(jax_query_variables_to_state_dict(variables),
                          strict=True)
    return model.eval()


@pytest.fixture(scope='module')
def pair():
    """(JAX model, JAX variables (numpy), port model) on the same seeded
    random weights; proposal boxes spread over the image."""
    jmodel, init = jq.init_query_model(jq.QueryDetectorConfig(**TINY),
                                       jax.random.PRNGKey(0),
                                       image_size=(H, W))
    variables = random_variables(to_numpy_tree(init), seed=31)
    return jmodel, variables, port_model(variables)


def clip_inputs(seed, b=B):
    rng = np.random.RandomState(seed)
    n = b * TINY['clip_length']
    imgs = rng.randn(n, H, W, 3).astype(np.float32)
    whwh = np.tile(np.asarray([[W, H, W, H]], np.float32), (n, 1))
    return imgs, whwh


@pytest.fixture(scope='module')
def stage_outputs(pair):
    jmodel, variables, port = pair
    imgs, whwh = clip_inputs(0)
    t = TINY['clip_length']
    jout = jax.jit(jmodel.apply, static_argnames='clip_length')(
        variables, jnp.asarray(imgs), jnp.asarray(whwh), clip_length=t)
    with torch.no_grad():
        pout = port(torch.from_numpy(imgs), torch.from_numpy(whwh), t)
    return ([{k: np.asarray(v) for k, v in s.items()}
             for s in jout['stages']],
            [{k: v.numpy() for k, v in s.items()} for s in pout['stages']])


def test_stages_match_jax(stage_outputs):
    jstages, pstages = stage_outputs
    assert len(pstages) == TINY['num_stages']
    for i, (j, p) in enumerate(zip(jstages, pstages)):
        assert set(p) == set(j) == {'cls_logits', 'boxes', 'blink_logits'}
        for k in j:
            assert p[k].shape == j[k].shape, (i, k)
        box_scale = max(np.abs(j['boxes']).max(), 1.0)
        assert np.abs(p['boxes'] - j['boxes']).max() <= 1e-3 * box_scale, i
        for k in ('cls_logits', 'blink_logits'):
            np.testing.assert_allclose(p[k], j[k], atol=1e-3, rtol=0,
                                       err_msg=f'stage {i} {k}')


@pytest.mark.parametrize('stage', [0, 1])
def test_generic_stqi_head_matches_jax(pair, stage):
    _, variables, port = pair
    c, t, q = TINY['channels'], TINY['clip_length'], TINY['num_queries']
    rng = np.random.RandomState(stage)
    n = B * t
    roi = rng.randn(n * q, 7, 7, c).astype(np.float32)
    query = rng.randn(n, q, c).astype(np.float32)
    head = jq.GenericSTQIHead(
        channels=c, num_heads=TINY['num_heads'],
        ffn_channels=TINY['ffn_channels'],
        feat_channels=TINY['dyn_feat_channels'],
        num_classes=TINY['num_classes'])
    ref = head.apply({'params': variables['params'][f'bbox_head_{stage}']},
                     jnp.asarray(roi), jnp.asarray(query), t)
    with torch.no_grad():
        got = port.roi_head.bbox_head[stage](torch.from_numpy(roi),
                                             torch.from_numpy(query), t)
    for name, g, r in zip(('cls_logits', 'deltas', 'obj', 'attn_feat'),
                          got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize('reference_semantics', [False, True])
def test_blink_head_matches_jax(pair, reference_semantics):
    _, variables, _ = pair
    port = port_model(variables,
                      blink_reference_semantics=reference_semantics)
    x = np.random.RandomState(5).randn(6, TINY['num_queries'],
                                       TINY['channels']).astype(np.float32)
    for stage in range(TINY['num_stages']):
        ref = jq.BlinkHead(TINY['channels'],
                           reference_semantics=reference_semantics).apply(
            {'params': variables['params'][f'blink_head_{stage}']},
            jnp.asarray(x))
        with torch.no_grad():
            got = port.roi_head.blink_head[stage](torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=0)


def _assert_tracks_equal(got, ref):
    assert set(got) == set(ref)
    for k in ('query_idx', 'labels'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ('scores', 'boxes', 'blink'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=1e-6, err_msg=k)


def test_topk_tracks_match_jax(stage_outputs):
    """On the model's last stage (distinct scores) the port selects the
    JAX tracks; one clip and the batched form of both clips."""
    jstages, _ = stage_outputs
    last = jstages[-1]
    t, k, c = TINY['clip_length'], TINY['max_per_img'], TINY['num_classes']
    clip0 = {key: v[:t] for key, v in last.items()}
    ref = jq.topk_tracks({key: jnp.asarray(v) for key, v in clip0.items()},
                         t, k, c)
    got = pq.topk_tracks({key: torch.from_numpy(v.copy())
                          for key, v in clip0.items()}, t, k, c)
    _assert_tracks_equal(got, ref)
    ref = jq.topk_tracks_batched({key: jnp.asarray(v)
                                  for key, v in last.items()}, B, t, k, c)
    got = pq.topk_tracks_batched({key: torch.from_numpy(v.copy())
                                  for key, v in last.items()}, B, t, k, c)
    _assert_tracks_equal(got, ref)


def test_topk_ties_go_to_lower_index():
    """Equal scores everywhere (every query at the whole-image init reads
    alike): lax.top_k and the port both take the lowest indices."""
    t, q, c, k = 3, 12, 2, 5
    rng = np.random.RandomState(2)
    stage = dict(cls_logits=np.zeros((2 * t, q, c), np.float32),
                 boxes=rng.rand(2 * t, q, 4).astype(np.float32),
                 blink_logits=rng.randn(2 * t, q).astype(np.float32))
    stage['cls_logits'][:, 7, 1] = 3.0        # one clear winner, then ties
    ref = jq.topk_tracks_batched({key: jnp.asarray(v)
                                  for key, v in stage.items()}, 2, t, k, c)
    got = pq.topk_tracks_batched({key: torch.from_numpy(v)
                                  for key, v in stage.items()}, 2, t, k, c)
    _assert_tracks_equal(got, ref)
    assert got['query_idx'][0].tolist() == [7, 0, 0, 1, 1]


def test_msgshift_is_not_ported():
    """The MsgShifT backbone is ported now (tests/test_torch_port_tevit.py
    holds it against JAX): the TeViT detector builds with its pyramid's
    widths in the FPN; an unknown backbone is refused."""
    model = pq.QueryDetector(pq.QueryDetectorConfig(
        backbone='msgshift', with_blink=False, num_classes=40))
    assert type(model.backbone).__name__ == 'MsgShifT'
    assert [m.conv.in_channels for m in model.neck.lateral_convs] == [
        64, 128, 320, 512]
    with pytest.raises(ValueError, match='msgshift'):
        pq.QueryDetector(pq.QueryDetectorConfig(backbone='resnet101'))


# ---------------------------------------------------- weights across packages

@pytest.fixture(scope='module')
def reference_pth(tmp_path_factory):
    """The reference-named state dict of tests/test_query_convert.py (with
    'module.' prefixes and the pre-rewrite mask_head names) as a .pth,
    and the JAX variables the JAX converter makes of it."""
    sd = query_state_dict(np.random.RandomState(0))
    path = str(tmp_path_factory.mktemp('ref') / 'instblink.pth')
    torch.save({'state_dict': {f'module.{k}': torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    _, init = jq.init_query_model(CONVERT_CFG, jax.random.PRNGKey(0),
                                  image_size=(64, 64))
    with pytest.warns(UserWarning, match='blink'):
        jvars = convert_query_torch_checkpoint(
            path, init, num_stages=CONVERT_CFG.num_stages,
            num_cls_fcs=CONVERT_CFG.num_cls_fcs,
            num_reg_fcs=CONVERT_CFG.num_reg_fcs)
    yield path, to_numpy_tree(jvars)
    shutil.rmtree(osp.dirname(path))


def _convert_port_cfg():
    fields = {f.name for f in dataclasses.fields(pq.QueryDetectorConfig)}
    return pq.QueryDetectorConfig(**{k: v for k, v in dataclasses.asdict(
        CONVERT_CFG).items() if k in fields})


def test_reference_pth_loads_natively_and_through_jax(reference_pth):
    """Native strict load == the JAX converter's variables carried across,
    tensor for tensor; and the port's state dict written as a .pth goes
    back through the JAX converter to the same variables."""
    path, jvars = reference_pth
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    model = pq.QueryDetector(_convert_port_cfg())
    model.load_state_dict(clean_reference_query_state_dict(
        ckpt['state_dict']), strict=True)
    native = model.state_dict()
    via_jax = jax_query_variables_to_state_dict(jvars)
    assert set(via_jax) == set(native)
    for k, v in via_jax.items():
        torch.testing.assert_close(native[k], v, rtol=0, atol=0, msg=k)

    back = path.replace('.pth', '_port.pth')
    torch.save({'state_dict': native}, back)
    _, init = jq.init_query_model(CONVERT_CFG, jax.random.PRNGKey(1),
                                  image_size=(64, 64))
    with pytest.warns(UserWarning, match='blink'):
        again = to_numpy_tree(convert_query_torch_checkpoint(
            back, init, num_stages=CONVERT_CFG.num_stages))
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(again),
            jax.tree_util.tree_leaves_with_path(jvars)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(kp))


def test_blink_tower_bias_refused_by_both(reference_pth, tmp_path):
    """The blink_fcs Linears are bias-free in the reference and in both
    packages: a checkpoint that carries such a bias has no slot on either
    side, and both refuse it rather than drop it."""
    sd = query_state_dict(np.random.RandomState(0))
    sd['roi_head.mask_head.0.blink_fcs.0.bias'] = np.ones(
        CONVERT_CFG.channels, np.float32)
    path = str(tmp_path / 'biased.pth')
    torch.save({'state_dict': {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    _, init = jq.init_query_model(CONVERT_CFG, jax.random.PRNGKey(0),
                                  image_size=(64, 64))
    with pytest.warns(UserWarning), pytest.raises(ValueError,
                                                  match='no slot'):
        convert_query_torch_checkpoint(path, init,
                                       num_stages=CONVERT_CFG.num_stages)
    model = pq.QueryDetector(_convert_port_cfg())
    with pytest.raises(RuntimeError, match='blink_fcs.0.bias'):
        model.load_state_dict(clean_reference_query_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()}), strict=True)
    shutil.rmtree(tmp_path)


def test_init_matches_jax_layout(pair):
    """init_query_model gives the JAX init's shapes under the reference
    names and its proposal init (whole-image boxes)."""
    _, variables, _ = pair
    model = pq.init_query_model(pq.QueryDetectorConfig(**TINY), seed=3,
                                device='cpu')
    ref = jax_query_variables_to_state_dict(variables)
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    np.testing.assert_array_equal(
        got['rpn_head.init_proposal_bboxes.weight'].numpy(),
        np.tile([0.5, 0.5, 1.0, 1.0], (TINY['num_queries'], 1)))


# ------------------------------------------------------------------ configs

def _assert_configs_equal(got, ref):
    for part in ('model', 'optim', 'data_train', 'data_test', 'eval_cfg'):
        assert dataclasses.asdict(getattr(got, part)) == \
            dataclasses.asdict(getattr(ref, part)), part
    for k in ('work_dir', 'checkpoint_interval', 'log_interval', 'seed'):
        assert getattr(got, k) == getattr(ref, k), k


LEGACY_MPEBLINK = '''
dataset_type = 'MPEblinkDataset'
clip_length = 11
img_norm_cfg = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12,
                    57.375], to_rgb=True)
train_pipeline = [dict(type='LoadImageFromFile'),
                  dict(type='Resize', img_scale=(640, 360), keep_ratio=True),
                  dict(type='RandomFlip', flip_ratio=0.5)]
test_pipeline = [dict(type='LoadImageFromFile'),
                 dict(type='Resize', img_scale=[(640, 360)],
                      keep_ratio=False)]
data = dict(samples_per_gpu=4, workers_per_gpu=2,
            train=dict(type=dataset_type, ann_file='a/train.json',
                       img_prefix='a/train/', pipeline=train_pipeline),
            test=dict(type=dataset_type, ann_file='a/test.json',
                      img_prefix='a/test/', pipeline=test_pipeline))
'''


def test_query_configs_match_jax(tmp_path):
    from mcgaze_tpu.utils.query_config import load_query_config as jload
    from mcgaze_tpu_torch.utils.query_config import load_query_config
    _assert_configs_equal(load_query_config(INSTBLINK_CFG),
                          jload(INSTBLINK_CFG))
    legacy = tmp_path / 'mpeblink.py'
    legacy.write_text(LEGACY_MPEBLINK)
    got = load_query_config(str(legacy))
    _assert_configs_equal(got, jload(str(legacy)))
    assert got.data_test.keep_ratio is False and got.data_train.keep_ratio
    assert got.data_train.canvas == (384, 640)


def test_query_config_loads_without_jax():
    """In a fresh interpreter the InstBlink config becomes the port's
    dataclasses and nothing of JAX or the JAX package is imported."""
    code = textwrap.dedent(f'''
        import sys
        from mcgaze_tpu_torch.utils.query_config import load_query_config
        cfg = load_query_config({INSTBLINK_CFG!r})
        assert type(cfg.model).__module__ == \\
            'mcgaze_tpu_torch.models.query_detector', type(cfg.model)
        assert type(cfg.data_train).__module__ == \\
            'mcgaze_tpu_torch.data.instblink_dataset'
        assert cfg.model.num_queries == 100 and cfg.model.num_stages == 6
        bad = [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'flax', 'mcgaze_tpu')]
        assert not bad, bad
    ''')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
