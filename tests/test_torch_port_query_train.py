"""The port's InstBlink training path against the JAX package's, on the CPU.

  * the numpy Jonker-Volgenant copy (train/hungarian.py::hungarian) against
    scipy's linear_sum_assignment in total cost, and against the JAX solver
    in the assignment itself, ties and PAD_COST columns included;
  * matching costs of a batch of clips at 1e-5 (f32), clip targets exact;
  * stage and total losses at 1e-5 relative, on the same stage outputs;
  * one train step of the tiny model (R-50 at 64x96, 2 stages, 10 queries,
    C=32; tests/test_torch_port_query.py's weights) against
    make_query_train_step, at the tolerances of the gaze train step
    (tests/test_torch_port_train.py): every log key at 1e-4 relative
    (grad_norm 2e-4), each gradient at 1e-3 of its largest |value|, each
    update at 2e-2 of its norm and 1e-3 of its largest element, frozen
    parameters unchanged. The port's side runs with mkldnn off: at this
    size mkldnn's f32 convolution backward puts layer4's gradients up to
    1.6% of their largest |value| from the float64 gradient, the native
    CPU convolution 1e-6, as XLA's does (the card runs cuDNN, not mkldnn);
  * the train CLI with --synthetic --device cpu, whose .pth the JAX
    converter reads, and the synthetic stream of the JAX CLI.
"""
import functools
import os.path as osp
import shutil

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp

from mcgaze_tpu.evaluation.forward import device_normalize as jnormalize
from mcgaze_tpu.models import query_detector as jq
from mcgaze_tpu.train import hungarian as jh
from mcgaze_tpu.train import loop as jloop
from mcgaze_tpu.train import query_criterion as jcrit
from mcgaze_tpu.train.query_loop import make_query_train_step as jmake_step
from mcgaze_tpu_torch.models import query_detector as pq
from mcgaze_tpu_torch.train import hungarian as ph
from mcgaze_tpu_torch.train import loop as ploop
from mcgaze_tpu_torch.train import query_criterion as pcrit
from mcgaze_tpu_torch.train import query_loop
from mcgaze_tpu_torch.utils.convert import jax_query_variables_to_state_dict
from tests.test_torch_port_model import random_variables, to_numpy_tree
from tests.test_torch_port_query import H, TINY, W
from tests.test_torch_port_train import STEP_OC, _assert_deltas_match
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
INSTBLINK_CFG = osp.join(ROOT, 'configs/instblink/instblink_r50_mpeblink.py')
T = TINY['clip_length']
B, M = 2, TINY['max_instances']
# the tiny model through the shipped config
TINY_OPTS = ([f'model.{k}={v}' for k, v in TINY.items()]
             + ['data_train.batch_size=2', 'data_train.canvas=64,96',
                f'data_train.clip_length={T}'])


# ------------------------------------------------------------- the solver

@pytest.mark.parametrize('m,n,seed', [(1, 1, 0), (3, 5, 1), (5, 5, 2),
                                      (8, 100, 3), (4, 10, 4)])
def test_hungarian_matches_scipy_cost(m, n, seed):
    cost = np.random.RandomState(seed).rand(m, n).astype(np.float32) * 10
    got = ph.hungarian(cost)
    assert len(set(got.tolist())) == m
    rows, cols = linear_sum_assignment(cost)
    np.testing.assert_allclose(cost[np.arange(m), got].sum(),
                               cost[rows, cols].sum(), rtol=1e-6)


@pytest.mark.parametrize('kind', ['random', 'ties', 'padded'])
def test_hungarian_matches_jax_assignment(kind):
    """The same assignment as the JAX solver, on ties too, where another
    optimal solver may pick another one."""
    rng = np.random.RandomState({'random': 0, 'ties': 1, 'padded': 2}[kind])
    for _ in range(6):
        if kind == 'ties':
            cost = rng.randint(0, 3, (6, 9)).astype(np.float32)
        else:
            cost = rng.rand(8, 30).astype(np.float32) * 5
        if kind == 'padded':
            cost[5:] = ph.PAD_COST
        got = ph.hungarian(cost)
        ref = np.asarray(jh.hungarian(jnp.asarray(cost)))
        np.testing.assert_array_equal(got, ref)


def test_solve_assignments_batches_one_round_trip():
    costs = torch.from_numpy(np.random.RandomState(5).rand(
        3, 2, 4, 12).astype(np.float32))
    got, seconds = ph.solve_assignments(costs)
    assert got.shape == (3, 2, 4) and got.dtype == torch.int64
    assert seconds >= 0.0
    for s in range(3):
        for b in range(2):
            np.testing.assert_array_equal(
                got[s, b].numpy(), ph.hungarian(costs[s, b].numpy()))


# ---------------------------------------------------- costs and targets

def gt_batch(seed, b=B, m=M, t=T, num_classes=TINY['num_classes']):
    """GT of b clips in the slot layout, with absent frames and one padded
    slot per clip."""
    rng = np.random.RandomState(seed)
    boxes = rng.rand(b, m, t, 4).astype(np.float32) * 40
    boxes[..., 2:] += boxes[..., :2] + 8
    present = rng.rand(b, m, t) > 0.25
    present[:, 0] = True
    valid = np.ones((b, m), bool)
    valid[:, -1] = False
    return dict(gt_boxes=boxes * present[..., None],
                gt_labels=rng.randint(0, num_classes, (b, m)).astype(
                    np.int32),
                gt_present=present, inst_valid=valid,
                gt_blinks=rng.randint(0, 2, (b, m, t)).astype(np.float32),
                whwh=np.tile(np.asarray([[W, H, W, H]], np.float32),
                             (b * t, 1)))


def stage_out(seed, b=B, t=T, q=TINY['num_queries'],
              c=TINY['num_classes']):
    rng = np.random.RandomState(seed)
    boxes = rng.rand(b * t, q, 4).astype(np.float32) * 50
    boxes[..., 2:] += boxes[..., :2] + 4
    return dict(cls_logits=rng.randn(b * t, q, c).astype(np.float32),
                boxes=boxes,
                blink_logits=rng.randn(b * t, q).astype(np.float32))


def as_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def as_jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def test_clip_costs_match_jax():
    gt, so = gt_batch(0), stage_out(1)
    q, c = TINY['num_queries'], TINY['num_classes']
    got = pcrit.stage_costs(pq.QueryDetectorConfig(**TINY), as_torch(so),
                            as_torch(gt), T).numpy()
    for ci in range(B):
        ref = jh.clip_cost_matrix(
            jnp.asarray(so['cls_logits'].reshape(B, T, q, c)[ci]),
            jnp.asarray(so['boxes'].reshape(B, T, q, 4)[ci]),
            jnp.asarray(gt['whwh'][ci * T]), jnp.asarray(gt['gt_boxes'][ci]),
            jnp.asarray(gt['gt_labels'][ci]),
            jnp.asarray(gt['gt_present'][ci]),
            jnp.asarray(gt['inst_valid'][ci]))
        np.testing.assert_allclose(got[ci], np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_clip_targets_match_jax():
    gt = gt_batch(2)
    rng = np.random.RandomState(3)
    match = np.stack([rng.permutation(TINY['num_queries'])[:M]
                      for _ in range(B)])
    got = ph.clip_targets_from_match(
        torch.from_numpy(match), *[torch.from_numpy(gt[k]) for k in (
            'gt_boxes', 'gt_labels', 'gt_present', 'inst_valid',
            'gt_blinks')], num_queries=TINY['num_queries'],
        num_classes=TINY['num_classes'])
    for ci in range(B):
        ref = jh.clip_targets_from_match(
            jnp.asarray(match[ci]), *[jnp.asarray(gt[k][ci]) for k in (
                'gt_boxes', 'gt_labels', 'gt_present', 'inst_valid',
                'gt_blinks')], num_queries=TINY['num_queries'],
            num_classes=TINY['num_classes'])
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k][ci].numpy(),
                                          np.asarray(ref[k]), err_msg=k)


def test_losses_match_jax():
    """Stage losses at the port's host match and total_loss over two
    stages, against the JAX criterion (which matches inside), 1e-5
    relative."""
    cfg = pq.QueryDetectorConfig(**TINY)
    jcfg = jq.QueryDetectorConfig(**TINY)
    gt = gt_batch(4)
    stages = [stage_out(5), stage_out(6)]
    _, plogs, _ = pcrit.total_loss(cfg, {'stages': [as_torch(s)
                                                    for s in stages]},
                                   as_torch(gt), T)
    _, jlogs = jcrit.total_loss(jcfg, {'stages': [as_jax(s)
                                                  for s in stages]},
                                as_jax(gt), T)
    assert set(plogs) == set(jlogs)
    for k in jlogs:
        np.testing.assert_allclose(float(plogs[k]), float(jlogs[k]),
                                   rtol=1e-5, err_msg=k)
    match = ph.solve_assignments(pcrit.stage_costs(
        cfg, as_torch(stages[0]), as_torch(gt), T))[0]
    got = pcrit.stage_losses(cfg, as_torch(stages[0]), as_torch(gt), T,
                             match)
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(jlogs[f'stage0_{k}']),
                                   rtol=1e-5, err_msg=k)


# -------------------------------------------------------------- train step

OC = dict(STEP_OC, ema_momentum=0.0)


@pytest.fixture(scope='module')
def weights():
    _, init = jq.init_query_model(jq.QueryDetectorConfig(**TINY),
                                  jax.random.PRNGKey(0), image_size=(H, W))
    return random_variables(to_numpy_tree(init), seed=41)


def train_batch(seed):
    rng = np.random.RandomState(seed + 100)
    batch = gt_batch(seed)
    batch['imgs'] = rng.randint(0, 256, (B * T, H, W, 3)).astype(np.uint8)
    # a frame whose content ends before the canvas: the pad is zeroed
    batch['whwh'][0] = [W - 10, H - 7, W - 10, H - 7]
    return batch


@functools.lru_cache(maxsize=None)
def _jax_grad_fn():
    cfg = jq.QueryDetectorConfig(**TINY)
    model = jq.QueryDetector(cfg)

    def loss_fn(params, stats, batch):
        imgs = jnormalize(batch['imgs'], batch['whwh'])
        out = model.apply({'params': params, 'stats': stats}, imgs,
                          batch['whwh'], clip_length=T)
        return jcrit.total_loss(cfg, out, batch, T)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope='module')
def step(weights):
    """One step of each package from the same weights and batch: logs,
    raw gradients, and the parameters before and after."""
    batch = train_batch(0)
    jb = as_jax(batch)
    _, jgrads = _jax_grad_fn()(weights['params'], weights['stats'], jb)
    oc = jloop.OptimConfig(**OC)
    jstate = jloop.TrainState(
        params=jax.tree.map(jnp.asarray, weights['params']),
        stats=jax.tree.map(jnp.asarray, weights['stats']),
        opt_state=jloop.make_optimizer(oc).init(weights['params']),
        step=jnp.zeros((), jnp.int32))
    jstate, jlogs = jmake_step(jq.QueryDetectorConfig(**TINY), oc)(jstate,
                                                                   jb)
    jafter = jax_query_variables_to_state_dict(
        {'params': to_numpy_tree(jstate.params),
         'stats': to_numpy_tree(jstate.stats)})

    cfg = pq.QueryDetectorConfig(**TINY)
    model = pq.QueryDetector(cfg)
    model.load_state_dict(jax_query_variables_to_state_dict(weights),
                          strict=True)
    state = query_loop.create_query_train_state(
        cfg, ploop.OptimConfig(**OC), model=model)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    pb = as_torch(batch)
    with torch.backends.mkldnn.flags(enabled=False):
        loss, _, _ = query_loop.query_loss_fn(cfg, model, pb)
        loss.backward()
        pgrads = {n: (p.grad.clone() if p.grad is not None
                      else torch.zeros_like(p))
                  for n, p in model.named_parameters()}
        plogs = query_loop.make_query_train_step(
            cfg, ploop.OptimConfig(**OC))(state, pb)
    assert state.step == 1
    return dict(
        jlogs={k: float(v) for k, v in jlogs.items()},
        plogs={k: float(v) for k, v in plogs.items()},
        jgrads=jax_query_variables_to_state_dict(
            {'params': to_numpy_tree(jgrads)}),
        pgrads=pgrads, before=before, jafter=jafter,
        pafter={k: v.detach().clone()
                for k, v in model.state_dict().items()})


def test_step_logs_match_jax(step):
    jlogs, plogs = step['jlogs'], step['plogs']
    assert set(plogs) == set(jlogs) | {'match_ms'}
    assert plogs['match_ms'] >= 0.0
    for k, v in jlogs.items():
        np.testing.assert_allclose(plogs[k], v,
                                   rtol=2e-4 if k == 'grad_norm' else 1e-4,
                                   err_msg=k)


def test_step_gradients_match_jax(step):
    jg, pg = step['jgrads'], step['pgrads']
    assert set(jg) == set(pg)
    for k, ref in jg.items():
        scale = max(ref.abs().max().item(), 1e-12)
        err = (pg[k] - ref).abs().max().item()
        assert err <= 1e-3 * scale, (k, err, scale)


def test_step_params_match_jax(step):
    before = step['before']
    params = set(step['pgrads'])
    got = {k: v for k, v in step['pafter'].items() if k in params}
    ref = {k: v for k, v in step['jafter'].items() if k in params}
    prev = {k: before[k] for k in params}
    _assert_deltas_match(got, ref, prev, prev, 'update', rtol=1e-3,
                         l2_rtol=2e-2)
    for k in params:
        if ploop.param_group(k) == 'frozen':
            assert torch.equal(step['pafter'][k], before[k]), k
    assert not torch.equal(step['pafter']['roi_head.bbox_head.0.fc_cls.weight'],
                           before['roi_head.bbox_head.0.fc_cls.weight'])


# ------------------------------------------------------------------- CLI

def test_synthetic_batches_match_jax_cli():
    from mcgaze_tpu.utils.cfg_options import apply_overrides as japply
    from mcgaze_tpu.utils.query_config import load_query_config as jload
    from mcgaze_tpu_torch.tools.train_instblink import synthetic_batches
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.query_config import load_query_config
    from tools.train_instblink import synthetic_batches as jsynthetic
    got = next(synthetic_batches(apply_overrides(
        load_query_config(INSTBLINK_CFG), TINY_OPTS), seed=4))
    ref = next(jsynthetic(japply(jload(INSTBLINK_CFG), TINY_OPTS), seed=4))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_train_cli_writes_pth_the_jax_converter_reads(tmp_path):
    """--synthetic --device cpu for 2 steps: finite logs, ckpt_2.pth that
    the JAX convert_query_torch_checkpoint merges strictly into the tiny
    model and that holds the port's weights; --resume-from continues."""
    from mcgaze_tpu.utils.torch_convert import convert_query_torch_checkpoint
    from mcgaze_tpu_torch.tools.train_instblink import main
    work = str(tmp_path / 'work')
    out = main([INSTBLINK_CFG, '--synthetic', '--device', 'cpu',
                '--max-iters', '2', '--work-dir', work, '--log-interval',
                '1', '--cfg-options', *TINY_OPTS])
    assert len(out['history']) == 2
    for h in out['history']:
        assert np.isfinite([h['loss'], h['grad_norm']]).all(), h
        assert h['match_ms'] >= 0.0
    assert out['checkpoint'] == osp.join(work, 'ckpt_2.pth')
    _, init = jq.init_query_model(jq.QueryDetectorConfig(**TINY),
                                  jax.random.PRNGKey(0), image_size=(H, W))
    with pytest.warns(UserWarning, match='blink'):
        conv = convert_query_torch_checkpoint(out['checkpoint'], init,
                                              num_stages=TINY['num_stages'])
    back = jax_query_variables_to_state_dict(to_numpy_tree(conv))
    now = out['state'].model.state_dict()
    for k, v in back.items():
        torch.testing.assert_close(now[k], v, rtol=0, atol=0, msg=k)

    again = main([INSTBLINK_CFG, '--synthetic', '--device', 'cpu',
                  '--max-iters', '3', '--work-dir', work, '--resume-from',
                  out['checkpoint'], '--cfg-options', *TINY_OPTS])
    assert len(again['history']) == 1 and again['state'].step == 3
    shutil.rmtree(tmp_path)
