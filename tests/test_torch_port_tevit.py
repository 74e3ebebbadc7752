"""The port's TeViT configuration (the query detector on the MsgShifT
backbone, no blink head) against the JAX package's, on the CPU.

Tiny detector: MsgShifT at its shipped widths on 64x96 frames (8 messenger
tokens), 2 stages, 8 queries, 5 classes, C=32; seeded random weights on
both sides (the JAX tree carried across by
jax_query_variables_to_state_dict), the same numpy inputs. Tolerances:
  * per stage, cls_logits and boxes (relative to their largest
    coordinate): 1e-3 with roi_impl='mm' (the model parity tolerance);
  * one train step at msg_drop_path_rate=0 against make_query_train_step,
    at the query step's tolerances (tests/test_torch_port_query_train.py):
    logs at 1e-4 relative (grad_norm 2e-4), each gradient at 1e-3 of its
    largest |value|, each update at 2e-2 of its norm and 1e-3 of its
    largest element; the port's side with mkldnn off, as there. On the
    weights of seed 51. The step's gradients move discontinuously
    where a ReLU's input crosses 0: on seed 51 one element of the stage-0
    DynamicConv's norm_in output (before its ReLU) is -1.34e-6 in float64,
    -1.82e-6 in JAX's f32 and +5.4e-8 in the port's (both packages' f32
    sit ~4e-7 on average, at most ~4e-6, from float64 there: rounding
    noise of the same size, not a systematic difference). That one ReLU
    puts one update 1.08e-3 of its max from JAX's; with the port taking
    JAX's ReLU mask at that unit, the step holds the tolerances above
    (ROADMAP Queue 3);
  * DropPath on its own (its mask stream cannot match JAX's): the linear
    ramp, per-frame masks shared by a frame's spatial and messenger
    tokens, 1/keep scaling, the same generator state giving the same
    masks, the step's generator a function of (step, rank);
  * the CLI chain train_instblink -> ckpt_2.pth -> test_instblink --eval
    on a fabricated blink-free YouTubeVIS-layout dataset
    (tests/test_tevit.py's), in seconds: no blink line, no blink fields,
    tracks at 1e-3 against the JAX CLI path in-process;
  * the shipped TeViT config loads with backbone 'msgshift' and no blink
    head, and --synthetic makes blink-free batches, as the JAX CLI's.
"""
import contextlib
import functools
import io
import json
import os
import os.path as osp
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mcgaze_tpu.evaluation.forward import device_normalize as jnormalize
from mcgaze_tpu.models import query_detector as jq
from mcgaze_tpu.train import loop as jloop
from mcgaze_tpu.train import query_criterion as jcrit
from mcgaze_tpu.train.query_loop import make_query_train_step as jmake_step
from mcgaze_tpu_torch.models import msgshift as pm
from mcgaze_tpu_torch.models.layers import init_weights
from mcgaze_tpu_torch.models import query_detector as pq
from mcgaze_tpu_torch.train import loop as ploop
from mcgaze_tpu_torch.train import query_loop
from mcgaze_tpu_torch.utils.convert import jax_query_variables_to_state_dict
from tests.test_torch_port_model import random_variables, to_numpy_tree
from tests.test_torch_port_query_train import (as_jax, as_torch, gt_batch)
from tests.test_torch_port_train import STEP_OC, _assert_deltas_match
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TEVIT_CFG = osp.join(ROOT, 'configs/tevit/tevit_msgshift_youtubevis.py')
TINY = dict(backbone='msgshift', num_stages=2, clip_length=2,
            num_queries=8, num_classes=5, with_blink=False, channels=32,
            ffn_channels=64, num_heads=4, dyn_feat_channels=16,
            max_per_img=4, max_instances=2, msg_num_tokens=8,
            msg_drop_path_rate=0.0, roi_impl='mm')
H, W = 64, 96
T = TINY['clip_length']
B, M = 2, TINY['max_instances']
TOL = 1e-3


def port_model(variables, **overrides):
    model = pq.QueryDetector(pq.QueryDetectorConfig(**{**TINY,
                                                       **overrides}))
    model.load_state_dict(jax_query_variables_to_state_dict(variables),
                          strict=True)
    return model.eval()


@functools.lru_cache(maxsize=None)
def seeded_weights(seed):
    """(JAX model, seeded random variables of the tiny detector)."""
    jmodel, init = jq.init_query_model(jq.QueryDetectorConfig(**TINY),
                                       jax.random.PRNGKey(0),
                                       image_size=(H, W))
    return jmodel, random_variables(to_numpy_tree(init), seed=seed)


@pytest.fixture(scope='module')
def pair():
    jmodel, variables = seeded_weights(51)
    return jmodel, variables, port_model(variables)


# ------------------------------------------------------------------ model

def test_tevit_config_loads():
    from mcgaze_tpu_torch.utils.query_config import load_query_config
    cfg = load_query_config(TEVIT_CFG)
    assert cfg.model.backbone == 'msgshift'
    assert cfg.model.with_blink is False
    assert (cfg.model.num_queries, cfg.model.num_stages,
            cfg.model.num_classes, cfg.model.clip_length) == (100, 6, 40, 5)
    assert cfg.data_train.with_blinks is False
    assert cfg.eval_cfg.clip_length == 5


def test_stages_match_jax(pair):
    jmodel, variables, port = pair
    rng = np.random.RandomState(0)
    imgs = rng.randn(B * T, H, W, 3).astype(np.float32)
    whwh = np.tile(np.asarray([[W, H, W, H]], np.float32), (B * T, 1))
    jout = jax.jit(jmodel.apply, static_argnames='clip_length')(
        variables, jnp.asarray(imgs), jnp.asarray(whwh), clip_length=T)
    with torch.no_grad():
        pout = port(torch.from_numpy(imgs), torch.from_numpy(whwh), T)
    assert len(pout['stages']) == TINY['num_stages']
    for i, (j, p) in enumerate(zip(jout['stages'], pout['stages'])):
        assert set(p) == set(j) == {'cls_logits', 'boxes'}
        j = {k: np.asarray(v) for k, v in j.items()}
        p = {k: v.numpy() for k, v in p.items()}
        box_scale = max(np.abs(j['boxes']).max(), 1.0)
        assert np.abs(p['boxes'] - j['boxes']).max() <= TOL * box_scale, i
        np.testing.assert_allclose(p['cls_logits'], j['cls_logits'],
                                   atol=TOL, rtol=0, err_msg=f'stage {i}')


# ------------------------------------------------------------- train step

OC = dict(STEP_OC, ema_momentum=0.0)


def train_batch(seed):
    rng = np.random.RandomState(seed + 100)
    batch = gt_batch(seed, b=B, m=M, t=T, num_classes=TINY['num_classes'])
    del batch['gt_blinks']
    batch['whwh'] = np.tile(np.asarray([[W, H, W, H]], np.float32),
                            (B * T, 1))
    batch['imgs'] = rng.randint(0, 256, (B * T, H, W, 3)).astype(np.uint8)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_grad_fn():
    cfg = jq.QueryDetectorConfig(**TINY)
    model = jq.QueryDetector(cfg)

    def loss_fn(params, batch):
        # also returns the CROSSING unit's output (below), captured in the
        # same forward
        imgs = jnormalize(batch['imgs'], batch['whwh'])
        out, state = model.apply(
            {'params': params}, imgs, batch['whwh'], clip_length=T,
            capture_intermediates=lambda mdl, _: mdl.name == 'norm_in',
            mutable=['intermediates'])
        loss, logs = jcrit.total_loss(cfg, out, batch, T)
        unit = state['intermediates']['bbox_head_0'][
            'instance_interactive_conv']['norm_in']['__call__'][0]
        return loss, (logs, unit)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


# The unit whose ReLU the port's f32 step crosses on seed 51: the stage-0
# DynamicConv's norm_in (its output goes through a ReLU), element (22, 36,
# 15) of its (32, 49, 16) output
CROSSING = 'roi_head.bbox_head.0.instance_interactive_conv.norm_in'
CROSSING_ELEMENT = (22, 36, 15)


@functools.lru_cache(maxsize=None)
def _jax_step_fn():
    return jmake_step(jq.QueryDetectorConfig(**TINY),
                      jloop.OptimConfig(**OC))


@functools.lru_cache(maxsize=None)
def jax_step(seed):
    """The JAX side of one step on seed's weights: the CROSSING unit's
    output in its forward, logs, gradients and the parameters after it, by
    port name."""
    _, weights = seeded_weights(seed)
    jb = as_jax(train_batch(0))
    (_, (_, unit)), jgrads = _jax_grad_fn()(weights['params'], jb)
    oc = jloop.OptimConfig(**OC)
    jstate = jloop.TrainState(
        params=jax.tree.map(jnp.asarray, weights['params']), stats={},
        opt_state=jloop.make_optimizer(oc).init(weights['params']),
        step=jnp.zeros((), jnp.int32))
    jstate, jlogs = _jax_step_fn()(jstate, jb)
    return dict(
        jax_pre=torch.from_numpy(np.array(unit)),
        jlogs={k: float(v) for k, v in jlogs.items()},
        jgrads=jax_query_variables_to_state_dict(
            {'params': to_numpy_tree(jgrads)}),
        jafter=jax_query_variables_to_state_dict(
            {'params': to_numpy_tree(jstate.params)}))


def port_step(seed, relu_mask=None, grads=True, weights=None):
    """The port's side of the same step (mkldnn off): its CROSSING unit's
    output in the first forward, gradients (without grads=False), logs
    and parameters. With
    relu_mask (JAX's CROSSING output > 0), the port's CROSSING output is
    set to 0 where JAX's ReLU passes nothing, so its ReLU there passes
    what JAX's passes. `weights`: seed's variables when the caller has
    them (seeded_weights)."""
    if weights is None:
        _, weights = seeded_weights(seed)
    cfg = pq.QueryDetectorConfig(**TINY)
    model = port_model(weights)
    seen = []

    def unit_hook(module, inputs, out):
        seen.append(out.detach().clone())
        return out if relu_mask is None else out.masked_fill(~relu_mask, 0.0)
    dict(model.named_modules())[CROSSING].register_forward_hook(unit_hook)
    state = query_loop.create_query_train_state(
        cfg, ploop.OptimConfig(**OC), model=model)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    pb = as_torch(train_batch(0))
    pgrads = None
    with torch.backends.mkldnn.flags(enabled=False):
        if grads:
            loss, _, _ = query_loop.query_loss_fn(cfg, model, pb)
            loss.backward()
            pgrads = {n: (p.grad.clone() if p.grad is not None
                          else torch.zeros_like(p))
                      for n, p in model.named_parameters()}
        plogs = query_loop.make_query_train_step(
            cfg, ploop.OptimConfig(**OC))(state, pb)
    return dict(
        port_pre=seen[0], plogs={k: float(v) for k, v in plogs.items()},
        pgrads=pgrads, before=before,
        pafter={k: v.detach().clone()
                for k, v in model.state_dict().items()})


def port_step_default_threads(seed, tmp_path):
    """port_step(seed, grads=False) in a fresh interpreter, where torch
    runs on its default threads, on seed's weights handed over in a file.
    Returns its CROSSING output and the parameters before and after."""
    weights = osp.join(tmp_path, 'weights.pkl')
    out = osp.join(tmp_path, 'port_step.pt')
    with open(weights, 'wb') as f:
        pickle.dump(seeded_weights(seed)[1], f)
    code = ('import pickle, sys, torch\n'
            'from tests.test_torch_port_tevit import port_step\n'
            'weights = pickle.load(open(sys.argv[2], "rb"))\n'
            'r = port_step(int(sys.argv[1]), grads=False, weights=weights)\n'
            'torch.save({k: r[k] for k in ("port_pre", "before", "pafter")},'
            ' sys.argv[3])\n')
    env = {k: v for k, v in os.environ.items()
           if k not in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS')}
    env['PYTHONPATH'] = ROOT
    proc = subprocess.run([sys.executable, '-c', code, str(seed), weights,
                           out], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = torch.load(out)
    shutil.rmtree(tmp_path)
    return result


@pytest.fixture(scope='module')
def step():
    """Both sides of one step on seed 51, the port taking JAX's ReLU mask
    at the CROSSING unit."""
    ref = jax_step(51)
    return dict(ref, **port_step(51, ref['jax_pre'] > 0))


def test_step_logs_match_jax(step):
    jlogs, plogs = step['jlogs'], step['plogs']
    assert set(plogs) == set(jlogs) | {'match_ms'}
    assert not any('blink' in k for k in plogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(plogs[k], v,
                                   rtol=2e-4 if k == 'grad_norm' else 1e-4,
                                   err_msg=k)


def test_step_gradients_match_jax(step):
    jg, pg = step['jgrads'], step['pgrads']
    assert set(jg) == set(pg)
    assert 'backbone.msg_tokens' in pg
    for k, ref in jg.items():
        scale = max(ref.abs().max().item(), 1e-12)
        err = (pg[k] - ref).abs().max().item()
        assert err <= 1e-3 * scale, (k, err, scale)


def test_step_params_match_jax(step):
    params = set(step['pgrads'])
    got = {k: v for k, v in step['pafter'].items() if k in params}
    ref = {k: v for k, v in step['jafter'].items() if k in params}
    prev = {k: step['before'][k] for k in params}
    _assert_deltas_match(got, ref, prev, prev, 'update', rtol=1e-3,
                         l2_rtol=2e-2)
    assert not torch.equal(step['pafter']['backbone.msg_tokens'],
                           step['before']['backbone.msg_tokens'])


def test_seed51_step_crosses_one_relu_without_the_jax_mask(tmp_path):
    """On seed 51 the port's f32 forward puts one element of the CROSSING
    unit on the other side of 0 from JAX's (and from float64), and no
    other element of it; left to its own ReLU there, the port's step puts
    backbone.layers.1.1.0.ffn.layers.4.weight's update more than 1e-3 of
    its largest change from JAX's. That rounding is the one torch's
    default threads give (one thread puts the element on JAX's side, and
    this module runs torch on one thread), so the port's step runs in a
    fresh interpreter, on torch's default threads."""
    ref = jax_step(51)
    ours = port_step_default_threads(51, tmp_path)
    jax_pre, port_pre = ref['jax_pre'], ours['port_pre']
    flips = ((port_pre > 0) != (jax_pre > 0)).nonzero().tolist()
    assert flips == [list(CROSSING_ELEMENT)]
    assert port_pre[CROSSING_ELEMENT] > 0 > jax_pre[CROSSING_ELEMENT]
    # the crossing is a 1e-6 rounding: both values lie that close to 0
    assert abs(port_pre[CROSSING_ELEMENT] - jax_pre[CROSSING_ELEMENT]) < 1e-5

    params = set(ref['jgrads'])
    prev = {k: ours['before'][k] for k in params}
    with pytest.raises(AssertionError,
                       match='backbone.layers.1.1.0.ffn.layers.4.weight'):
        _assert_deltas_match({k: ours['pafter'][k] for k in params},
                             {k: ref['jafter'][k] for k in params}, prev,
                             prev, 'update', rtol=1e-3)


# ---------------------------------------------------------------- DropPath

def test_droppath_ramp():
    model = pq.QueryDetector(pq.QueryDetectorConfig(
        backbone='msgshift', with_blink=False, msg_drop_path_rate=0.1))
    rates = [blk.drop_path for _, blocks, _ in model.backbone.layers
             for blk in blocks]
    assert len(rates) == 16
    np.testing.assert_allclose(rates, [0.1 * i / 15 for i in range(16)],
                               rtol=1e-12)


def test_droppath_masks_per_frame_shared_and_scaled():
    """A layer at rate 0.5 under a generator equals the layer's branches
    recomputed by hand with the masks drawn from the same generator state:
    one (N, 1, 1) mask per branch, the same one on a frame's spatial and
    messenger tokens, kept rows scaled by 1/keep = 2."""
    layer = pm.PVTEncoderLayer(8, 1, 16, 2, drop_path=0.5)
    init_weights(layer, torch.Generator().manual_seed(0))
    n, hw = 16, (4, 4)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(n, 16, 8).astype(np.float32))
    msg = torch.from_numpy(rng.randn(n, 4, 8).astype(np.float32))
    with torch.no_grad():
        got_x, got_msg = layer(x, hw, msg, torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)
        ax, amsg = layer.attn(layer.norm1(x), hw, layer.norm1(msg))
        m1 = pm.drop_path_mask(n, 0.5, gen, x.dtype, x.device)
        x1, msg1 = x + ax * m1, msg + amsg * m1
        fx, fmsg = layer.ffn(layer.norm2(x1), hw, layer.norm2(msg1))
        m2 = pm.drop_path_mask(n, 0.5, gen, x.dtype, x.device)
    assert m1.shape == (n, 1, 1)
    assert set(m1.flatten().tolist()) | set(m2.flatten().tolist()) == {0.0,
                                                                        2.0}
    assert not torch.equal(m1, m2)
    torch.testing.assert_close(got_x, x1 + fx * m2, rtol=0, atol=0)
    torch.testing.assert_close(got_msg, msg1 + fmsg * m2, rtol=0, atol=0)
    # a dropped frame keeps its input on both token sets; a kept one adds
    # twice the branch
    dropped = int(torch.nonzero(m1.flatten() == 0)[0])
    torch.testing.assert_close(x1[dropped], x[dropped], rtol=0, atol=0)
    torch.testing.assert_close(msg1[dropped], msg[dropped], rtol=0, atol=0)


def test_droppath_same_generator_state_same_masks(pair):
    _, variables, _ = pair
    model = port_model(variables, msg_drop_path_rate=0.5)
    x = torch.from_numpy(np.random.RandomState(1).randn(
        B * T, H, W, 3).astype(np.float32))
    whwh = torch.tensor([[W, H, W, H]], dtype=torch.float32).expand(
        B * T, 4)

    def run(gen):
        with torch.no_grad():
            return model(x, whwh, T, train=True,
                         generator=gen)['stages'][-1]['cls_logits']

    a = run(query_loop.droppath_generator(3, 'cpu'))
    b = run(query_loop.droppath_generator(3, 'cpu'))
    c = run(query_loop.droppath_generator(4, 'cpu'))
    d = run(query_loop.droppath_generator(3, 'cpu', rank=1))
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    with torch.no_grad():
        ev = model(x, whwh, T)['stages'][-1]['cls_logits']
    assert not torch.equal(a, ev)
    with pytest.raises(ValueError, match='Generator'):
        model(x, whwh, T, train=True)


def test_train_step_with_droppath_replays(pair):
    """Two steps from the same weights and step counter with DropPath at
    0.1 give the same logs (a resumed run replays its masks); the step
    counter moves them."""
    _, variables, _ = pair
    cfg = pq.QueryDetectorConfig(**{**TINY, 'msg_drop_path_rate': 0.1})
    batch = as_torch(train_batch(1))

    def one(step):
        model = port_model(variables, msg_drop_path_rate=0.1)
        state = query_loop.create_query_train_state(
            cfg, ploop.OptimConfig(**OC), model=model)
        state.step = step
        return query_loop.make_query_train_step(
            cfg, ploop.OptimConfig(**OC))(state, batch)['loss'].item()

    a, b, c = one(5), one(5), one(6)
    assert np.isfinite(a) and a == b and a != c


# ------------------------------------------------------------------- CLIs

def test_synthetic_batches_are_blink_free_as_jax():
    from mcgaze_tpu.utils.cfg_options import apply_overrides as japply
    from mcgaze_tpu.utils.query_config import load_query_config as jload
    from mcgaze_tpu_torch.tools.train_instblink import synthetic_batches
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.query_config import load_query_config
    from tools.train_instblink import synthetic_batches as jsynthetic
    opts = ['data_train.batch_size=2', 'data_train.canvas=64,96']
    got = next(synthetic_batches(apply_overrides(
        load_query_config(TEVIT_CFG), opts), seed=2))
    ref = next(jsynthetic(japply(jload(TEVIT_CFG), opts), seed=2))
    assert 'gt_blinks' not in got and set(got) == set(ref)
    assert got['imgs'].shape == (2 * 5, 64, 96, 3)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_cli_chain_matches_jax_cli_path(tmp_path):
    """train_instblink (2 steps on the fabricated dataset) -> ckpt_2.pth ->
    test_instblink --eval, against the JAX CLI's steps on the same files
    and checkpoint."""
    cv2 = pytest.importorskip('cv2')  # noqa: F841
    from mcgaze_tpu.data.instblink_dataset import \
        InstBlinkClipDataset as JDataset
    from mcgaze_tpu.evaluation.forward import bind_query_forward as jbind
    from mcgaze_tpu.evaluation.forward import make_query_eval_forward as jmk
    from mcgaze_tpu.evaluation.instblink_driver import \
        InstBlinkVideoEvaluator as JEvaluator
    from mcgaze_tpu.utils.query_config import load_query_config as jload
    from mcgaze_tpu.utils.torch_convert import convert_query_torch_checkpoint
    from mcgaze_tpu_torch.tools import test_instblink, train_instblink
    from tests.test_tevit import TEVIT_TINY_CFG, _fabricate_ytvis

    _fabricate_ytvis(tmp_path)
    cfg_path = tmp_path / 'tevit_tiny.py'
    cfg_path.write_text(TEVIT_TINY_CFG.format(root=tmp_path))
    out = train_instblink.main([str(cfg_path), '--device', 'cpu',
                                '--max-iters', '2', '--log-interval', '1'])
    assert len(out['history']) == 2
    for h in out['history']:
        assert np.isfinite([h['loss'], h['grad_norm']]).all(), h
        assert not any('blink' in k for k in h)
    ckpt = out['checkpoint']
    assert ckpt == str(tmp_path / 'work' / 'ckpt_2.pth')

    buf = io.StringIO()
    res_path = str(tmp_path / 'results.json')
    with contextlib.redirect_stdout(buf):
        got = test_instblink.main([str(cfg_path), ckpt, '--out', res_path,
                                   '--eval', '--device', 'cpu'])
    text = buf.getvalue()
    assert 'track mAP' in text and 'blink action AP' not in text
    assert got['metrics']['mAP'] >= 0.0 and 'blink_ap' not in got['metrics']
    results = got['results']
    assert results
    with open(res_path) as f:
        assert json.load(f) == json.loads(json.dumps(results))
    for tr in results:
        assert 'blink_scores' not in tr and 'blinks_converted' not in tr
        assert len(tr['bboxes']) == 6

    cfg = jload(str(cfg_path))
    model, variables = jq.init_query_model(cfg.model, jax.random.PRNGKey(0),
                                           image_size=cfg.data_test.canvas)
    variables = convert_query_torch_checkpoint(
        ckpt, variables, num_stages=cfg.model.num_stages, with_blink=False,
        backbone='msgshift')
    ds = JDataset(cfg.data_test)
    evaluator = JEvaluator(jbind(*jmk(model, cfg.model), variables),
                           cfg.eval_cfg, data_cfg=cfg.data_test)
    ref = [t for tracks in evaluator.run_videos_from_paths(
        (v, ds.video_paths(v)) for v in ds.api.get_vid_ids())
        for t in tracks]
    assert len(results) == len(ref)
    for g, r in zip(results, ref):
        assert set(g) == set(r)
        assert (g['video_id'], g['category_id']) == (r['video_id'],
                                                     r['category_id'])
        assert abs(g['score'] - r['score']) <= TOL
        assert [b is None for b in g['bboxes']] == \
            [b is None for b in r['bboxes']]
        gb = np.asarray([b for b in g['bboxes'] if b is not None])
        rb = np.asarray([b for b in r['bboxes'] if b is not None])
        assert np.abs(gb - rb).max() <= TOL * max(np.abs(rb).max(), 1.0)
    shutil.rmtree(tmp_path)
