"""The port's training path against the JAX package, on the CPU.

Small config (R26, 2 stages, FFN 256, 32 px, two 7-frame clips, the size
of tests/test_train_step.py), the same seeded random weights on both sides
(jax_variables_to_state_dict) and the same numpy batches. Two train steps
against make_train_step, at an lr, clip, decay and EMA that make each part
of the update visible (STEP_OC):
  * loss and every log key 1e-4 relative, grad_norm 2e-4 (f32 on both
    sides, convolutions and ~30 layers summed in another order);
  * each parameter's gradient 1e-3 of its largest |value| (the model
    parity tolerance of tests/test_torch_port_model.py);
  * each update and EMA change at 2e-2 of its norm, the first step's also
    at 1e-3 of its largest element, and the parameters after the first
    step at rtol 2e-4, atol 3e-6
    (tests/test_train_step.py::_sharded_equivalence);
  * frozen parameters (stem, layer1) bit-unchanged.
Fed the same gradients, the update and EMA agree with optax's at 1e-3 of
each tensor's largest |update|.
Also: the schedule, the parameter groups, the config loader (in a fresh
interpreter, without the JAX package), the clip dataset, the synthetic
stream and the train CLI's checkpoints.
"""
import dataclasses
import functools
import json
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
import optax

from mcgaze_tpu.evaluation.forward import device_normalize as jnormalize
from mcgaze_tpu.models.mcgaze import MCGazeModel as JModel
from mcgaze_tpu.models.mcgaze import ModelConfig as JModelConfig
from mcgaze_tpu.models.mcgaze import init_model as jinit_model
from mcgaze_tpu.train import loop as jloop
from mcgaze_tpu.train.hooks import ema_update as jema_update
from mcgaze_tpu.train.criterion import total_loss as jtotal_loss
from mcgaze_tpu.train.targets import flatten_targets as jflatten
from mcgaze_tpu_torch.models.mcgaze import MCGazeModel, ModelConfig
from mcgaze_tpu_torch.train import loop as ploop
from mcgaze_tpu_torch.utils.convert import jax_variables_to_state_dict
from tests.test_torch_port_model import random_variables, to_numpy_tree
from tests.test_train_step import make_batch
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SMALL = dict(backbone_depth=26, num_stages=2, ffn_channels=256,
             stage_loss_weights=(1.0, 1.0))
IMG, T = 32, 7
GAZE_CFG = osp.join(ROOT, 'configs/multiclue_gaze/multiclue_gaze_r50_gaze360.py')
L2CS_CFG = osp.join(ROOT, 'configs/multiclue_gaze/multiclue_gaze_r50_l2cs.py')


def np_batch(seed):
    return {k: np.asarray(v) for k, v in
            make_batch(np.random.RandomState(seed)).items()}


@pytest.fixture(scope='module')
def weights():
    """JAX variables (numpy) of the small model, seeded random."""
    _, init = jinit_model(JModelConfig(**SMALL), jax.random.PRNGKey(0),
                          image_size=(IMG, IMG))
    return random_variables(to_numpy_tree(init), seed=21)


def port_model(variables):
    model = MCGazeModel(ModelConfig(**SMALL))
    model.load_state_dict(jax_variables_to_state_dict(variables),
                          strict=True)
    return model


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad():
    cfg = JModelConfig(**SMALL)
    model = JModel(cfg)

    def loss_fn(params, stats, batch):
        imgs = batch['imgs'].reshape(-1, IMG, IMG, 3)
        whwh = batch['img_whwh'].reshape(-1, 4)
        out = model.apply({'params': params, 'stats': stats},
                          jnormalize(imgs, whwh), whwh, clip_length=T)
        tg = jflatten(batch['gt_boxes'], batch['gt_valid'],
                      batch['gt_gazes'], batch['img_whwh'])
        return jtotal_loss(cfg, out, tg, T)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def jax_grads(variables, batch):
    """jax.value_and_grad of the JAX train step's loss (loop.py
    loss_fn), at the given variables (numpy) and batch."""
    (_, logs), grads = _jax_value_and_grad()(
        variables['params'], variables['stats'],
        {k: jnp.asarray(v) for k, v in batch.items()})
    return logs, to_numpy_tree(grads)


# Two steps on two batches, inside a warmup that changes the lr from
# step to step (1e-4, then 3.25e-4); a clip 1e8 times below the gradients'
# norm, so that most clipped gradients fall below Adam's eps (1e-8) and
# the update scales with the clip factor; a weight decay large enough to
# move a parameter above f32's resolution; an EMA that moves by a tenth of
# each update. The update then shows the schedule's timing, the backbone
# lr multiplier, the clip's norm and scale, weight decay on parameters
# without a gradient and the EMA.
STEP_OC = dict(lr=1e-3, warmup_iters=4, warmup_ratio=0.1,
               grad_clip_norm=1e-5, weight_decay=0.5, ema_momentum=0.1)


def _jax_tensors(params, stats, ema):
    """(parameters and BN statistics, EMA) of the JAX side by port name."""
    return (jax_variables_to_state_dict(
        {'params': to_numpy_tree(params), 'stats': to_numpy_tree(stats)}),
        jax_variables_to_state_dict({'params': to_numpy_tree(ema)}))


def _pstate_tensors(pstate):
    return ({k: v.detach().clone()
             for k, v in pstate.model.state_dict().items()},
            {k: v.clone() for k, v in pstate.ema.items()})


@pytest.fixture(scope='module')
def steps(weights):
    """Two steps of each package from the same weights and batches: per
    step the logs, the parameters, buffers and EMA after it, and the first
    step's raw gradients."""
    batches = [np_batch(0), np_batch(1)]
    jtx = jloop.make_optimizer(jloop.OptimConfig(**STEP_OC))
    jstate = jloop.TrainState(
        params=jax.tree.map(jnp.asarray, weights['params']),
        stats=jax.tree.map(jnp.asarray, weights['stats']),
        opt_state=jtx.init(weights['params']),
        step=jnp.zeros((), jnp.int32),
        ema_params=jax.tree.map(jnp.array, weights['params']))
    jstep = jloop.make_train_step(JModelConfig(**SMALL),
                                  jloop.OptimConfig(**STEP_OC))
    _, jgrads = jax_grads(weights, batches[0])
    jlogs, jafter = [], []
    for batch in batches:
        jstate, logs = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        jlogs.append({k: float(v) for k, v in logs.items()})
        jafter.append(_jax_tensors(jstate.params, jstate.stats,
                                   jstate.ema_params))
    assert int(jstate.step) == 2

    model = port_model(weights)
    pstate = ploop.create_train_state(ModelConfig(**SMALL),
                                      ploop.OptimConfig(**STEP_OC),
                                      model=model)
    before = _pstate_tensors(pstate)
    pbatches = [{k: torch.from_numpy(v.copy()) for k, v in b.items()}
                for b in batches]
    loss, _ = ploop.loss_fn(model.cfg, model, pbatches[0])
    loss.backward()
    pgrads = {n: (p.grad.clone() if p.grad is not None
                  else torch.zeros_like(p))
              for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    pstep = ploop.make_train_step(ModelConfig(**SMALL),
                                  ploop.OptimConfig(**STEP_OC))
    plogs, pafter = [], []
    for batch in pbatches:
        plogs.append({k: float(v) for k, v in pstep(pstate, batch).items()})
        pafter.append(_pstate_tensors(pstate))
    assert pstate.step == 2
    return dict(jlogs=jlogs, jafter=jafter, jgrads=jgrads, plogs=plogs,
                pafter=pafter, pgrads=pgrads, before=before, pstate=pstate)


def test_schedule_matches_jax():
    for oc in (ploop.OptimConfig(),
               ploop.OptimConfig(warmup_iters=10, lr_steps=(20, 30))):
        joc = jloop.OptimConfig(**dataclasses.asdict(oc))
        ps, js = (ploop.step_warmup_schedule(oc),
                  jloop.step_warmup_schedule(joc))
        for t in (0, 5, 500, 999, 1000, 5999, 6000, 25, 31):
            assert ps(t) == pytest.approx(float(js(t)), rel=1e-6), t
    s = ploop.step_warmup_schedule(ploop.OptimConfig())
    assert s(0) == pytest.approx(1e-6, rel=1e-4)      # f32: 1 - 0.999
    assert s(1000) == pytest.approx(1e-3, rel=1e-6)
    assert s(6000) == pytest.approx(1e-4, rel=1e-6)


def test_param_groups_match_jax(weights):
    """Every parameter's group, on the port's names, equals _param_group
    on the JAX path it was converted from. Each JAX leaf is filled with
    its index, so the converted tensor tells which leaf it came from."""
    leaves = jax.tree_util.tree_leaves_with_path(weights['params'])
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(weights['params']),
        [np.full(np.shape(v), i, np.float32)
         for i, (_, v) in enumerate(leaves)])
    sd = jax_variables_to_state_dict({'params': tagged})
    model = port_model(weights)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(sd)
    groups = {}
    for name in names:
        path = leaves[int(sd[name].flatten()[0])][0]
        assert ploop.param_group(name) == jloop._param_group(path), name
        groups[ploop.param_group(name)] = groups.get(
            ploop.param_group(name), 0) + 1
    assert set(groups) == {'frozen', 'backbone', 'head'}
    opt_params = {id(p) for g in ploop.make_optimizer(
        model, ploop.OptimConfig()).param_groups for p in g['params']}
    assert len(opt_params) == groups['backbone'] + groups['head']


def test_one_step_logs_match_jax(steps):
    """Every log key of both steps; the second step's loss is taken at the
    parameters the first update left."""
    for jlogs, plogs in zip(steps['jlogs'], steps['plogs']):
        assert sorted(plogs) == sorted(jlogs)
        assert len(plogs) == 2 * 14 + 2
        for k in jlogs:
            rtol = 2e-4 if k == 'grad_norm' else 1e-4
            np.testing.assert_allclose(plogs[k], jlogs[k], rtol=rtol,
                                       err_msg=k)
    # the clip scales every step's update
    assert min(x['grad_norm'] for x in steps['jlogs']) > 1e7 * \
        STEP_OC['grad_clip_norm']


def test_one_step_gradients_match_jax(steps):
    """Each parameter's raw gradient (frozen ones included: they enter
    grad_norm) at 1e-3 of its largest |value|; the proposal boxes get
    none on either side."""
    ref = jax_variables_to_state_dict({'params': steps['jgrads']})
    got = steps['pgrads']
    assert sorted(got) == sorted(ref)
    for name, g in got.items():
        r = ref[name]
        scale = max(r.abs().max().item(), 1e-12)
        err = (g - r).abs().max().item()
        assert err <= 1e-3 * scale, (name, err, scale)
    assert got['rpn_head.init_proposal_bboxes.weight'].abs().max() == 0


F32_EPS = float(np.finfo(np.float32).eps)


def _assert_deltas_match(got, ref, got_prev, ref_prev, what, rtol=None,
                         l2_rtol=None):
    """Each tensor's change over a step against the JAX step's. The two
    packages round the new value in other steps (torch decays p in place,
    then adds the Adam step; optax adds one combined update), so 2 ulp of
    each new value are allowed first; what is left must be at most `rtol`
    of the tensor's largest |change|, or its norm at most `l2_rtol` of the
    change's norm. Returns the names that changed by more than that
    rounding."""
    changed = []
    for name, r in ref.items():
        dref = (r - ref_prev[name]).double()
        dgot = (got[name] - got_prev[name]).double()
        excess = ((dgot - dref).abs()
                  - 2 * F32_EPS * r.double().abs()).clamp_min(0)
        if rtol is not None:
            scale = dref.abs().max().item()
            assert excess.max().item() <= rtol * scale, (
                what, name, excess.max().item(), scale)
        if l2_rtol is not None:
            scale = dref.norm().item()
            assert excess.norm().item() <= l2_rtol * scale, (
                what, name, excess.norm().item(), scale)
        if (dref.abs() > 2 * F32_EPS * r.double().abs()).any():
            changed.append(name)
    return changed


def test_one_step_params_match_jax(steps):
    """Each step of make_train_step against the JAX one, tensor by tensor.
    The first step's update p_new - p_old and EMA change at 1e-3 of the
    tensor's largest |update| (seen: 9e-5). In the second, Adam divides
    each element by its own gradient history, so where the two batches'
    gradients nearly cancel, their f32 differences grow in the update (seen:
    7e-3 of the largest |update|): each step is held at 2e-2 of the
    update's norm (seen: 2e-3). A wrong sign, lr multiplier, schedule step,
    decay of the proposal boxes or EMA is of the order of the update. After
    the first step the parameters also agree at rtol 2e-4, atol 3e-6
    (tests/test_train_step.py), below its largest update of 1e-4. Frozen
    parameters and BN statistics are bit-unchanged; every trainable
    parameter moves, the proposal boxes by weight decay alone."""
    p_prev, e_prev = steps['before']
    j_prev = p_prev, e_prev
    for t, ((pp, pe), (jp, je)) in enumerate(zip(steps['pafter'],
                                                 steps['jafter'])):
        rtol = 1e-3 if t == 0 else None
        moved = _assert_deltas_match(pp, jp, p_prev, j_prev[0],
                                     f'update {t}', rtol, l2_rtol=2e-2)
        ema_moved = _assert_deltas_match(pe, je, e_prev, j_prev[1],
                                         f'EMA {t}', rtol, l2_rtol=2e-2)
        for name, v in pp.items():
            if t == 0:
                np.testing.assert_allclose(v.numpy(), jp[name].numpy(),
                                           rtol=2e-4, atol=3e-6,
                                           err_msg=name)
            if ploop.param_group(name) == 'frozen' or 'running_' in name:
                assert torch.equal(v, steps['before'][0][name]), name
        trainable = sorted(n for n in pe if ploop.param_group(n) != 'frozen')
        assert sorted(moved) == sorted(ema_moved) == trainable
        assert 'rpn_head.init_proposal_bboxes.weight' in moved
        p_prev, e_prev = pp, pe
        j_prev = jp, je
    opt = steps['pstate'].optimizer
    boxes = steps['pstate'].model.rpn_head.init_proposal_bboxes.weight
    assert int(opt.state[boxes]['step']) == 2


def test_update_matches_optax_on_same_gradients(weights, monkeypatch):
    """The port's update (a zero gradient where autograd left none, the
    frozen mask, optax's clip rule, the lr schedule read before the count
    increments, AdamW with the backbone lr x0.1, the EMA) against optax's
    chain (jloop.make_optimizer) and ema_update, both fed the same
    gradients over two steps: the JAX gradients of two batches, the second
    at the parameters the first update left, with the frozen parameters'
    scaled by 30 so that they would dominate the clip norm if they entered
    it (unscaled they are 0.13% of it). make_train_step's loss is
    replaced by sum(p * grad), whose backward leaves exactly those
    gradients, and none on the proposal boxes, as the model does. Each
    tensor's update and EMA change at 1e-3 of its largest |update| plus 2
    ulp of the new value (seen: 9e-5). torch's clip_grad_norm_ would
    differ from optax's rule by a factor 1 + 1e-6 / norm, below this
    tolerance: the port writes the optax rule out."""
    joc = jloop.OptimConfig(**STEP_OC)
    jtx = jloop.make_optimizer(joc)
    params = jax.tree.map(jnp.asarray, weights['params'])
    opt_state, ema = jtx.init(params), params
    grads, refs = [], []
    for seed in (0, 1):
        _, g = jax_grads({'params': to_numpy_tree(params),
                          'stats': weights['stats']}, np_batch(seed))
        g = jax.tree_util.tree_map_with_path(
            lambda path, x: x * (30.0 if jloop._param_group(path) == 'frozen'
                                 else 1.0), g)
        grads.append(jax_variables_to_state_dict({'params': g}))
        updates, opt_state = jtx.update(jax.tree.map(jnp.asarray, g),
                                        opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jema_update(ema, params, joc.ema_momentum)
        refs.append(_jax_tensors(params, weights['stats'], ema))

    boxes = 'rpn_head.init_proposal_bboxes.weight'
    assert not grads[0][boxes].any()

    def planted_loss(cfg, model, g):
        loss = sum((p * g[n]).sum() for n, p in model.named_parameters()
                   if n != boxes)
        return loss, {'loss': loss.detach()}

    monkeypatch.setattr(ploop, 'loss_fn', planted_loss)
    state = ploop.create_train_state(ModelConfig(**SMALL),
                                     ploop.OptimConfig(**STEP_OC),
                                     model=port_model(weights))
    step = ploop.make_train_step(state.model.cfg, ploop.OptimConfig(**STEP_OC))
    prev = before = _pstate_tensors(state)
    ref_prev = before
    for t, (g, ref) in enumerate(zip(grads, refs)):
        logs = step(state, g)
        np.testing.assert_allclose(
            float(logs['grad_norm']),
            float(torch.linalg.vector_norm(torch.stack(
                [x.norm() for x in g.values()]))), rtol=1e-6)
        got = _pstate_tensors(state)
        moved = _assert_deltas_match(got[0], ref[0], prev[0], ref_prev[0],
                                     f'update {t}', rtol=1e-3)
        ema_moved = _assert_deltas_match(got[1], ref[1], prev[1],
                                         ref_prev[1], f'EMA {t}', rtol=1e-3)
        trainable = sorted(n for n in got[1]
                           if ploop.param_group(n) != 'frozen')
        assert sorted(moved) == sorted(ema_moved) == trainable
        assert boxes in moved
        for name in before[0]:
            if ploop.param_group(name) == 'frozen' or 'running_' in name:
                assert torch.equal(got[0][name], before[0][name]), name
        prev, ref_prev = got, ref


def test_train_mode_changes_nothing(weights):
    """The model has no dropout and FrozenBN reads its running statistics:
    train() and eval() give the same numbers."""
    model = port_model(weights)
    rng = np.random.RandomState(3)
    imgs = torch.from_numpy(rng.randn(T, IMG, IMG, 3).astype(np.float32))
    whwh = torch.full((T, 4), float(IMG))
    with torch.no_grad():
        a = model.eval()(imgs, whwh)
        b = model.train()(imgs, whwh)
    for sa, sb in zip(a['stages'], b['stages']):
        assert torch.equal(sa['boxes'], sb['boxes'])
        assert torch.equal(sa['cls_logits'], sb['cls_logits'])
        for k in sa['gaze']:
            assert torch.equal(sa['gaze'][k], sb['gaze'][k])


def test_loss_falls_over_steps(weights):
    """Three steps on one batch with a usable lr lower the loss and leave
    the frozen stem and layer1 untouched (tests/test_train_step.py)."""
    oc = ploop.OptimConfig(warmup_iters=1, warmup_ratio=1.0,
                           grad_clip_norm=10.0, lr=1e-3)
    state = ploop.create_train_state(ModelConfig(**SMALL), oc,
                                     model=port_model(weights))
    stem = state.model.backbone.conv1.weight.detach().clone()
    l1 = state.model.backbone.layer1[0].conv1.weight.detach().clone()
    step = ploop.make_train_step(state.model.cfg, oc)
    batch = {k: torch.from_numpy(v) for k, v in np_batch(0).items()}
    losses = [float(step(state, batch)['loss']) for _ in range(3)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert torch.equal(state.model.backbone.conv1.weight, stem)
    assert torch.equal(state.model.backbone.layer1[0].conv1.weight, l1)


def test_ema_update_matches_jax():
    from mcgaze_tpu.train.hooks import ema_update as jema
    from mcgaze_tpu_torch.train.hooks import ema_update as pema
    rng = np.random.RandomState(4)
    e = {'a': rng.randn(5, 3).astype(np.float32),
         'b': rng.randn(7).astype(np.float32)}
    p = {k: rng.randn(*v.shape).astype(np.float32) for k, v in e.items()}
    ref = jema(e, p, 0.01)
    got = pema({k: torch.from_numpy(v.copy()) for k, v in e.items()},
               {k: torch.from_numpy(v) for k, v in p.items()}, 0.01)
    for k in e:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6)


_LOAD_PROBE = r'''
import dataclasses, json, sys
from mcgaze_tpu_torch.utils.config import load_config
cfg = load_config(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'mcgaze_tpu'))
print(json.dumps(dict(bad=bad, cfg=dataclasses.asdict(cfg))))
'''


def _legacy_config(tmp_path):
    path = tmp_path / 'legacy.py'
    path.write_text(textwrap.dedent("""
        clip_length = 7
        model = dict(
            type='MultiClueGaze', backbone=dict(type='ResNet', depth=50),
            roi_head=dict(
                type='MultiClueGazeROIHead', num_stages=4,
                stage_loss_weights=[1, 1, 0.5, 1],
                bbox_head=[dict(loss_cls=dict(type='FocalLoss', gamma=2.0,
                                              alpha=0.25, loss_weight=2.0),
                                loss_bbox=dict(loss_weight=5.0),
                                loss_iou=dict(loss_weight=2.0))] * 4,
                gaze_head=[dict(loss_gaze=dict(type='GazeCosLoss',
                                               loss_weight=6.0),
                                loss_temp=dict(loss_weight=1.0))] * 4))
        optimizer = dict(type='AdamW', lr=0.001, weight_decay=0.0001,
                         paramwise_cfg=dict(custom_keys={
                             'backbone': dict(lr_mult=0.1)}))
        optimizer_config = dict(grad_clip=dict(max_norm=0.1))
        lr_config = dict(policy='step', step=[6000], warmup_iters=1000)
        runner = dict(type='IterBasedRunner', max_iters=7000)
        data = dict(samples_per_gpu=4,
                    train=dict(ann_file='a.json', img_prefix='imgs/',
                               pipeline=[dict(type='CenterCrop',
                                              crop_size=(0.68, 0.68)),
                                         dict(type='Resize',
                                              img_scale=(224, 224)),
                                         dict(type='RandomFlip',
                                              flip_ratio=0.5)]),
                    test=dict(ann_file='t.json', img_prefix='imgs/'))
        work_dir = './work_dirs/legacy'
        """))
    return str(path)


@pytest.mark.parametrize('which', ['gaze360', 'l2cs', 'legacy'])
def test_config_loads_without_jax_and_matches(which, tmp_path):
    """The port's loader, in a fresh interpreter, imports no jax, flax or
    mcgaze_tpu, and its Config equals the JAX load_config's field by
    field."""
    from mcgaze_tpu.utils.config import load_config as jload
    path = {'gaze360': GAZE_CFG, 'l2cs': L2CS_CFG}.get(which) or \
        _legacy_config(tmp_path)
    out = subprocess.run([sys.executable, '-c', _LOAD_PROBE, path],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got['bad'] == []
    ref = json.loads(json.dumps(dataclasses.asdict(jload(path))))
    assert got['cfg'] == ref


def test_config_refuses_other_jax_imports(tmp_path):
    from mcgaze_tpu_torch.utils.config import load_config
    path = tmp_path / 'bad.py'
    path.write_text('from mcgaze_tpu.ops.roi_align import roi_levels\n')
    with pytest.raises(ImportError, match='never imports the JAX'):
        load_config(str(path))


def test_cfg_options_match_jax():
    from mcgaze_tpu.utils.cfg_options import apply_overrides as japply
    from mcgaze_tpu.utils.config import load_config as jload
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config
    opts = ['model.num_stages=2', 'optim.lr_steps=10,20',
            'data_train.crop_size=none', 'log_interval=3']
    got = apply_overrides(load_config(GAZE_CFG), opts)
    ref = japply(jload(GAZE_CFG), opts)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_dataset_batches_match_jax(tmp_path):
    """The port's clip dataset yields the JAX Python path's batches, number
    for number, for one seed on a fabricated COCO-VID set (crop, flip,
    head-only frames)."""
    from mcgaze_tpu.data.dataset import DataConfig as JDataConfig
    from mcgaze_tpu.data.dataset import Gaze360ClipDataset as JDataset
    from mcgaze_tpu_torch.data.dataset import DataConfig, Gaze360ClipDataset
    from tests.test_data_and_driver import make_dataset
    ann, prefix = make_dataset(str(tmp_path))
    kw = dict(ann_file=ann, img_prefix=prefix, clip_length=7,
              scale=(32, 32), canvas=(32, 32), crop_size=0.68,
              flip_ratio=0.5, batch_size=2)
    ours = Gaze360ClipDataset(DataConfig(**kw), seed=3, use_native=False)
    ref = JDataset(JDataConfig(**kw), seed=3, use_native=False)
    assert ours.index == ref.index
    flips = 0
    for a, b in zip((next(it) for it in [ours.batches(seed=5)] * 3),
                    (next(it) for it in [ref.batches(seed=5)] * 3)):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        flips += int((a['gt_gazes'][..., 0] != 0).any())
    assert flips


def test_training_transforms_match_jax():
    from mcgaze_tpu.data import transforms as JT
    from mcgaze_tpu_torch.data import transforms as PT
    rng = np.random.RandomState(6)
    img = rng.randint(0, 255, (48, 64, 3), np.uint8)
    boxes = np.array([[20, 10, 40, 24], [22, 14, 38, 19], [14, 4, 46, 34]],
                     np.float32)
    valid = np.ones(3, np.float32)
    gazes = np.array([[0.3, 0.1, -0.9]] * 3, np.float32)
    for ratio, flip in ((0.7, True), (None, True), (0.9, False)):
        kw = dict(boxes=boxes, valid=valid, gazes=gazes)
        a = PT.process_frame(img, PT.ClipParams(ratio, flip), (224, 224),
                             (224, 224), **kw)
        b = JT.process_frame(img, JT.ClipParams(ratio, flip), (224, 224),
                             (224, 224), **kw)
        ga = PT.process_frame_geometry((48, 64), PT.ClipParams(ratio, flip),
                                       (224, 224), **kw)
        gb = JT.process_frame_geometry((48, 64), JT.ClipParams(ratio, flip),
                                       (224, 224), **kw)
        for k in ('img', 'whwh', 'scale_factor', 'boxes', 'valid', 'gazes'):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ('whwh', 'scale_factor', 'boxes', 'valid', 'gazes'):
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
        assert a['ok'] == b['ok'] and ga['ok'] == gb['ok']
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(5):
        assert (dataclasses.asdict(PT.sample_clip_params(r1, 0.68, 0.5)) ==
                dataclasses.asdict(JT.sample_clip_params(r2, 0.68, 0.5)))


def test_synthetic_batches_match_jax_cli():
    from mcgaze_tpu.utils.config import load_config as jload
    from mcgaze_tpu_torch.tools.train import synthetic_batches
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config
    from tools.train import synthetic_batches as jsynthetic
    opts = ['data_train.batch_size=2', 'data_train.canvas=32,32']
    got = next(synthetic_batches(apply_overrides(load_config(GAZE_CFG),
                                                 opts), seed=4))
    from mcgaze_tpu.utils.cfg_options import apply_overrides as japply
    ref = next(jsynthetic(japply(jload(GAZE_CFG), opts), seed=4))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_train_cli_checkpoint_reloads(tmp_path):
    """--synthetic --device cpu --max-iters 2 writes ckpt_2.pth, which a
    fresh model loads with strict=True through clean_reference_state_dict,
    and ckpt_2_train.pth, from which --auto-resume continues at step 2;
    --max-keep-ckpts 1 then leaves only step 3's files."""
    from mcgaze_tpu_torch.tools.train import main
    from mcgaze_tpu_torch.utils.checkpoint import (find_latest_checkpoint,
                                                   restore_checkpoint)
    from mcgaze_tpu_torch.utils.convert import clean_reference_state_dict
    argv = [GAZE_CFG, '--synthetic', '--device', 'cpu', '--max-iters', '2',
            '--work-dir', str(tmp_path), '--log-interval', '1',
            '--cfg-options', 'model.backbone_depth=26', 'model.num_stages=2',
            'model.stage_loss_weights=1.0,1.0', 'model.ffn_channels=256',
            'data_train.batch_size=1', 'data_train.canvas=32,32',
            'optim.ema_momentum=0.001']
    out = main(argv)
    assert len(out['history']) == 2
    assert all(np.isfinite(h['loss']) and np.isfinite(h['grad_norm'])
               for h in out['history'])
    assert out['checkpoint'] == find_latest_checkpoint(str(tmp_path))
    assert osp.basename(out['checkpoint']) == 'ckpt_2.pth'
    fresh = MCGazeModel(out['state'].model.cfg)
    fresh.load_state_dict(clean_reference_state_dict(
        restore_checkpoint(out['checkpoint'])['state_dict']), strict=True)
    for k, v in out['state'].model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    lines = (tmp_path / 'train_log.jsonl').read_text().splitlines()
    assert [json.loads(x)['step'] for x in lines] == [1, 2]

    resumed = main(argv[:argv.index('--max-iters') + 1] + ['3'] +
                   argv[argv.index('--max-iters') + 2:] +
                   ['--auto-resume', '--max-keep-ckpts', '1'])
    assert resumed['state'].step == 3 and len(resumed['history']) == 1
    assert osp.exists(tmp_path / 'ckpt_3_train.pth')
    # --max-keep-ckpts 1 pruned step 2's pair
    assert sorted(p.name for p in tmp_path.glob('ckpt_*')) == [
        'ckpt_3.pth', 'ckpt_3_train.pth']
    shutil.rmtree(tmp_path)         # a model + train pair, ~0.6 GB


@pytest.mark.parametrize('flag', ['--validate', '--mesh=2,1'])
def test_train_cli_unported_flags_raise(flag, tmp_path):
    """Both flags are ported now; what still raises before the first step:
    --validate reads its val JSON (a missing one raises), and --mesh D,M
    needs D x M processes (one runs here), for a data axis (2,1) and a
    model axis (1,2) alike."""
    from mcgaze_tpu_torch.tools.train import main
    argv = [GAZE_CFG, '--synthetic', '--device', 'cpu', '--work-dir',
            str(tmp_path), flag]
    if flag == '--validate':
        with pytest.raises(FileNotFoundError):
            main(argv + ['--val-json', str(tmp_path / 'missing.json')])
    else:
        with pytest.raises(ValueError, match='needs 2 processes'):
            main(argv)
        with pytest.raises(ValueError, match='needs 2 processes'):
            main(argv[:-1] + ['--mesh=1,2'])


def test_device_put_batches_on_cpu():
    from mcgaze_tpu_torch.data.prefetch import device_put_batches
    host = [{'a': np.arange(6, dtype=np.float32).reshape(2, 3) + i}
            for i in range(3)]
    it = device_put_batches(iter(host), 'cpu')
    got = [next(it) for _ in range(3)]
    it.close()
    for g, h in zip(got, host):
        assert torch.equal(g['a'], torch.from_numpy(h['a']))


def test_hooks_and_timer(tmp_path):
    from mcgaze_tpu_torch.train.hooks import CheckInvalidLoss, TextLogger
    from mcgaze_tpu_torch.utils.profiling import IterTimer
    guard = CheckInvalidLoss(interval=2)
    guard.after_iter(1, {'loss': float('nan')})        # off-interval
    with pytest.raises(FloatingPointError, match='iter 2'):
        guard.after_iter(2, {'loss': torch.tensor(float('inf'))})
    timer = IterTimer()
    log = TextLogger(str(tmp_path), max_iters=3, interval=2)
    for step in (1, 2, 3):
        timer.before_iter()
        timer.after_iter(sync=torch.zeros(()))
        log.after_iter(step, {'loss': torch.tensor(1.5)}, 1e-3, timer)
    lines = [json.loads(x) for x in
             (tmp_path / 'train_log.jsonl').read_text().splitlines()]
    assert [x['step'] for x in lines] == [2, 3]
    assert lines[0]['loss'] == 1.5 and 'data_time' in lines[0]


def test_checkpoint_files(tmp_path):
    from mcgaze_tpu_torch.utils.checkpoint import (find_latest_checkpoint,
                                                   restore_checkpoint,
                                                   save_checkpoint)
    assert find_latest_checkpoint(str(tmp_path / 'none')) is None
    for s in (2, 10, 3):
        save_checkpoint(str(tmp_path), s, {'w': torch.full((2,), s)},
                        train_state={'step': s})
    save_checkpoint(str(tmp_path), 20, {'w': torch.ones(2)})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(['ckpt_2.pth', 'ckpt_2_train.pth', 'ckpt_3.pth',
                            'ckpt_3_train.pth', 'ckpt_10.pth',
                            'ckpt_10_train.pth', 'ckpt_20.pth'])
    latest = find_latest_checkpoint(str(tmp_path))
    assert latest.endswith('ckpt_20.pth')
    ckpt = restore_checkpoint(str(tmp_path / 'ckpt_10.pth'))
    assert ckpt['meta'] == {'step': 10}
    assert torch.equal(ckpt['state_dict']['w'], torch.full((2,), 10))


def test_checkpoint_max_to_keep(tmp_path):
    """Three saves with max_to_keep=2 leave the last two model/train
    pairs, as the JAX save_checkpoint prunes its directories; a model file
    saved without a train file is pruned alone."""
    from mcgaze_tpu_torch.utils.checkpoint import save_checkpoint
    for s in (1, 2, 3):
        save_checkpoint(str(tmp_path), s, {'w': torch.full((2,), s)},
                        train_state={'step': s}, max_to_keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        'ckpt_2.pth', 'ckpt_2_train.pth', 'ckpt_3.pth', 'ckpt_3_train.pth']
    save_checkpoint(str(tmp_path), 10, {'w': torch.ones(2)}, max_to_keep=1)
    assert [p.name for p in tmp_path.iterdir()] == ['ckpt_10.pth']
