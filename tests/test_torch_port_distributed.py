"""The port's data parallelism (parallel/{distributed,mesh}.py, DDP in the
train steps, rank-sharded eval), on the CPU.

  * the single-process cases of tests/test_distributed.py: every helper a
    no-op without a process group, the strided shard and the gather's
    order restore inverse for any (items, processes), the structure
    fingerprint, init_distributed's reading of the torchrun and JAX
    environment names (the process group call replaced), the mesh's
    refusals (a model axis names ROADMAP item 12b);
  * two gloo processes, each a subprocess with its own timeout (as
    tests/test_multiprocess.py runs JAX's): the seed of rank 0, shard and
    gather in input order with unequal payloads over 16 MiB, the structure
    check;
  * one gaze train step on 2 ranks x half the batch against 1 process x
    the whole batch, on a batch whose halves hold different positive
    counts: loss, grad norm and every parameter at 1e-5 relative (each
    update at 1e-3 of its norm, see _assert_params_match); the same for
    one query train step (InstBlink R-50 and TeViT, tiny). Both
    sides keep mkldnn on: its convolution gives each clip the same bits
    whatever the batch, where the native CPU convolution moves features
    by ~6e-6 of their max between 2 and 4 clips, which the ReLUs amplify
    to 4e-5 of the gradient norm;
  * tools.test on 2 ranks writes the results JSON of 1 process, and the
    train CLI with --mesh 2,1 --validate runs, rank 0 alone logging,
    validating and writing checkpoints.
"""
import json
import os
import os.path as osp
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import mcgaze_tpu_torch.parallel.distributed as D
from mcgaze_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
GAZE_CFG = osp.join(REPO, 'configs/multiclue_gaze/multiclue_gaze_r50_gaze360.py')
TIMEOUT = 300

# ------------------------------------------------------ one process

def test_single_process_fallbacks():
    assert D.process_count() == 1 and D.process_index() == 0
    assert D.sync_random_seed(42) == 42
    assert isinstance(D.sync_random_seed(None), int)
    items = list(range(10))
    assert D.shard_across_processes(items) == items
    assert D.gather_objects([1, 2, 3]) == [1, 2, 3]
    D.barrier('x')
    D.assert_same_structure({'a': np.zeros(3)})
    counts = torch.tensor([0.0, 3.0])
    assert D.global_normalizer(counts).tolist() == [1.0, 3.0]
    logs = {'loss': torch.tensor(2.0)}
    assert D.average_over_processes(logs) is logs


@pytest.mark.parametrize('n_items,n_procs', [(10, 3), (7, 2), (5, 5),
                                             (4, 8)])
def test_strided_shard_round_trips(monkeypatch, n_items, n_procs):
    """shard_across_processes on each rank, then gather_objects' order
    restore, give back the list (the allgather replaced by the shards)."""
    items = list(range(n_items))
    shards = []
    for p in range(n_procs):
        monkeypatch.setattr(D, 'process_index', lambda p=p: p)
        monkeypatch.setattr(D, 'process_count', lambda: n_procs)
        shards.append(D.shard_across_processes(items))
    iters = [iter(s) for s in shards]
    restored = [next(iters[i % n_procs]) for i in range(n_items)]
    assert restored == items


def test_structure_fingerprint_sensitivity():
    fp = D.tree_structure_fingerprint
    a = {'x': np.zeros((2, 3), np.float32), 'y': [torch.zeros(2)]}
    b = {'y': [torch.ones(2)], 'x': np.ones((2, 3), np.float32)}
    assert fp(a) == fp(b)
    assert fp(a) != fp({'x': np.zeros((3, 2), np.float32),
                        'y': [torch.zeros(2)]})
    assert fp(a) != fp({'x': np.zeros((2, 3), np.float64),
                        'y': [torch.zeros(2)]})
    assert fp(a) != fp({'z': np.zeros((2, 3), np.float32),
                        'y': [torch.zeros(2)]})


@pytest.mark.parametrize('names', ['torchrun', 'jax'])
def test_init_distributed_env_parsing(monkeypatch, names):
    calls = {}

    def fake_init(backend, init_method, world_size, rank, timeout,
                  **kwargs):
        calls.update(backend=backend, init_method=init_method,
                     world_size=world_size, rank=rank)

    for n in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
              'COORDINATOR_ADDRESS', 'JAX_COORDINATOR_ADDRESS',
              'NUM_PROCESSES', 'JAX_NUM_PROCESSES', 'PROCESS_ID',
              'JAX_PROCESS_ID'):
        monkeypatch.delenv(n, raising=False)
    if names == 'torchrun':
        env = dict(MASTER_ADDR='10.0.0.1', MASTER_PORT='1234',
                   WORLD_SIZE='4', RANK='3')
    else:
        env = dict(COORDINATOR_ADDRESS='10.0.0.1:1234', NUM_PROCESSES='4',
                   PROCESS_ID='3')
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(D.dist, 'init_process_group', fake_init)
    monkeypatch.setattr(D, '_active', lambda: False)
    assert D.init_distributed('cpu') is True
    assert calls == dict(backend='gloo', init_method='tcp://10.0.0.1:1234',
                         world_size=4, rank=3)


def test_init_distributed_noop_without_launcher(monkeypatch):
    for n in ('MASTER_ADDR', 'COORDINATOR_ADDRESS',
              'JAX_COORDINATOR_ADDRESS'):
        monkeypatch.delenv(n, raising=False)
    monkeypatch.setattr(D.dist, 'init_process_group',
                        lambda *a, **k: pytest.fail('called'))
    assert D.init_distributed('cpu') is False
    assert D.process_count() == 1


def test_mesh_refusals_and_no_wrap_without_group():
    assert pmesh.make_mesh() == pmesh.Mesh(1, 1)
    assert pmesh.parse_mesh('1,1') == pmesh.Mesh(1, 1)
    with pytest.raises(NotImplementedError, match='item 12b'):
        pmesh.parse_mesh('1,2')
    with pytest.raises(ValueError, match='needs 2 processes'):
        pmesh.make_mesh(2)
    model = torch.nn.Linear(2, 2)
    assert pmesh.wrap_model(model, 'cpu') is model


# ------------------------------------------------------------ workers

SMALL = dict(backbone_depth=26, num_stages=2, ffn_channels=256,
             stage_loss_weights=(1.0, 1.0))
OC = dict(lr=1e-3, warmup_iters=4, warmup_ratio=0.1, grad_clip_norm=1e-5,
          weight_decay=0.5)
GAZE_B, GAZE_T, GAZE_IMG = 4, 7, 32
QUERY = dict(num_stages=2, clip_length=3, num_queries=10, num_classes=2,
             channels=32, ffn_channels=64, num_heads=4, dyn_feat_channels=16,
             max_per_img=4, max_instances=3, roi_impl='mm')
QUERY_TEVIT = dict(QUERY, backbone='msgshift', with_blink=False,
                   msg_num_tokens=8, msg_drop_path_rate=0.0)
QUERY_B, QUERY_H, QUERY_W = 2, 64, 96


def gaze_batch(seed=0):
    """B clips at 32 px; the first half of the clips has every slot
    valid, the second half slot 0 on alternate frames only, so the two
    ranks hold different positive counts."""
    rng = np.random.RandomState(seed)
    b, t, s = GAZE_B, GAZE_T, GAZE_IMG
    xy = rng.rand(b, t, 3, 2).astype(np.float32) * 12
    wh = rng.rand(b, t, 3, 2).astype(np.float32) * 12 + 6
    gazes = rng.randn(b, t, 3, 3).astype(np.float32)
    gazes /= np.linalg.norm(gazes, axis=-1, keepdims=True)
    valid = np.ones((b, t, 3), np.float32)
    valid[b // 2:] = 0.0
    valid[b // 2:, ::2, 0] = 1.0
    return dict(
        imgs=rng.randint(0, 256, (b, t, s, s, 3)).astype(np.uint8),
        img_whwh=np.full((b, t, 4), s, np.float32),
        gt_boxes=np.concatenate([xy, xy + wh], -1) * valid[..., None],
        gt_valid=valid, gt_gazes=gazes * valid[..., None])


def query_batch(cfg: dict, seed=0):
    """B clips; clip 0 holds three present instances, clip 1 one
    instance on its first frame only."""
    rng = np.random.RandomState(seed)
    b, t, m = QUERY_B, cfg['clip_length'], cfg['max_instances']
    h, w = QUERY_H, QUERY_W
    boxes = rng.rand(b, m, t, 4).astype(np.float32) * 30
    boxes[..., 2:] += boxes[..., :2] + 8
    present = np.ones((b, m, t), bool)
    valid = np.ones((b, m), bool)
    valid[1, 1:] = False
    present[1, 0, 1:] = False
    batch = dict(
        imgs=rng.randint(0, 256, (b * t, h, w, 3)).astype(np.uint8),
        whwh=np.tile(np.asarray([[w, h, w, h]], np.float32), (b * t, 1)),
        gt_boxes=boxes * present[..., None],
        gt_labels=rng.randint(0, cfg['num_classes'], (b, m)).astype(
            np.int32),
        gt_present=present, inst_valid=valid)
    if cfg.get('with_blink', True):
        batch['gt_blinks'] = rng.randint(0, 2, (b, m, t)).astype(np.float32)
    return batch


def _shard(batch: dict, rank: int, world: int, clip_rows: dict) -> dict:
    """This rank's contiguous share of the clips; clip_rows[k] is the rows
    per clip of entry k (T for frame-major entries, else 1)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // clip_rows.get(k, 1)
        per = n // world * clip_rows.get(k, 1)
        out[k] = torch.from_numpy(np.ascontiguousarray(
            v[rank * per:(rank + 1) * per]))
    return out


def gaze_step(batch: dict, ddp: bool):
    from mcgaze_tpu_torch.models.mcgaze import ModelConfig, init_model
    from mcgaze_tpu_torch.train import loop
    cfg = ModelConfig(**SMALL)
    oc = loop.OptimConfig(**OC)
    model = init_model(cfg, seed=3, device='cpu')
    state = loop.create_train_state(cfg, oc, model=model)
    if ddp:
        state.ddp = pmesh.wrap_model(model, 'cpu')
    logs = loop.make_train_step(cfg, oc)(state, batch)
    return logs, model.state_dict()


def query_step(cfg_kw: dict, batch: dict, ddp: bool):
    from mcgaze_tpu_torch.models import query_detector as pq
    from mcgaze_tpu_torch.train import loop, query_loop
    cfg = pq.QueryDetectorConfig(**cfg_kw)
    oc = loop.OptimConfig(**OC)
    model = pq.init_query_model(cfg, seed=4, device='cpu')
    state = query_loop.create_query_train_state(cfg, oc, model=model)
    if ddp:
        state.ddp = pmesh.wrap_model(model, 'cpu')
    logs = query_loop.make_query_train_step(cfg, oc)(state, batch)
    return logs, model.state_dict()


def _worker(mode: str, out_dir: str, *extra):
    """One rank of a multi-process test (or a lone process, without a
    launcher's environment): joins the gloo group from the environment
    and writes its result to out_dir/rank<r>.json."""
    torch.set_num_threads(1)
    D.init_distributed('cpu')
    rank, world = D.process_index(), D.process_count()
    result = {'world': world}
    if mode == 'collectives':
        result['seed'] = D.sync_random_seed(1000 + rank)
        items = list(range(7))
        local = [(i, bytes([i]) * (17 << 20) if i == 0 else i)
                 for i in D.shard_across_processes(items)]
        D.barrier('gather')
        got = D.gather_objects(local)
        result['order'] = [i for i, _ in got]
        result['big'] = len(got[0][1])
        D.assert_same_structure({'a': np.zeros((2, 3))}, 'same')
        try:
            D.assert_same_structure({'a': np.zeros((2, 3 + rank))}, 'diff')
            result['mismatch_raised'] = False
        except AssertionError:
            result['mismatch_raised'] = True
        norm = D.global_normalizer(torch.tensor([float(rank), 0.0]))
        result['normalizer'] = norm.tolist()
    elif mode == 'gaze_step':
        batch = _shard(gaze_batch(), rank, world, {})
        logs, sd = gaze_step(batch, ddp=True)
        result['logs'] = {k: float(v) for k, v in logs.items()}
        if rank == 0:
            torch.save(sd, osp.join(out_dir, 'params.pth'))
    elif mode.startswith('query_step'):
        cfg_kw = QUERY_TEVIT if mode.endswith('tevit') else QUERY
        t = cfg_kw['clip_length']
        batch = _shard(query_batch(cfg_kw), rank, world,
                       {'imgs': t, 'whwh': t})
        logs, sd = query_step(cfg_kw, batch, ddp=True)
        result['logs'] = {k: float(v) for k, v in logs.items()}
        if rank == 0:
            torch.save(sd, osp.join(out_dir, 'params.pth'))
    elif mode == 'test_cli':
        from mcgaze_tpu_torch.tools import test as ptest
        out = ptest.main(list(extra))
        result['results'] = out['results'] is not None
    elif mode == 'train_cli':
        from mcgaze_tpu_torch.tools import train as ptrain
        out = ptrain.main(list(extra))
        result.update(checkpoint=out['checkpoint'],
                      validation=out['validation'],
                      steps=len(out['history']),
                      loss=out['history'][-1]['loss'])
    with open(osp.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(result, f)
    D.shutdown_distributed()


def _free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


LAUNCH_ENV = ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
              'COORDINATOR_ADDRESS', 'JAX_COORDINATOR_ADDRESS',
              'NUM_PROCESSES', 'PROCESS_ID')


def run_two(tmp_path, mode, *extra, jax_names=False, world=2):
    """Run _worker(mode) in `world` gloo processes (world=1: one process
    without a launcher); returns each rank's result."""
    port = _free_port()
    procs = []
    for rank in range(world):
        if world == 1:
            env = {}
        elif jax_names:
            env = dict(COORDINATOR_ADDRESS=f'127.0.0.1:{port}',
                       NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
        else:
            env = dict(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(rank))
        base = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
        env = dict(base, PYTHONPATH=REPO, OMP_NUM_THREADS='1', **env)
        code = ('import sys; from tests.test_torch_port_distributed '
                'import _worker; _worker(*sys.argv[1:])')
        procs.append(subprocess.Popen(
            [sys.executable, '-c', code, mode, str(tmp_path), *extra],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f'rc={p.returncode}\n{out}\n{err[-3000:]}'
    results = []
    for rank in range(world):
        with open(tmp_path / f'rank{rank}.json') as f:
            results.append(json.load(f))
    return results


# ------------------------------------------------------- two processes

def test_two_process_collectives(tmp_path):
    r0, r1 = run_two(tmp_path, 'collectives', jax_names=True)
    for r in (r0, r1):
        assert r['seed'] == 1000
        assert r['order'] == list(range(7))
        assert r['big'] == 17 << 20
        assert r['mismatch_raised'] is True
        assert r['normalizer'] == [0.5, 0.5]


def _assert_params_match(got: dict, ref: dict, before: dict):
    """Every parameter at 1e-5 relative (1e-7 absolute near 0), and each
    tensor's update at 1e-3 of its norm: the backbone's updates are ~50 ulp
    of its weights (lr x 0.1), so the rounding of the new value alone puts
    them ~6e-4 apart. Some update must exceed the parameter tolerance
    tenfold, so the comparison sees the step."""
    seen = 0.0
    for k, r in ref.items():
        torch.testing.assert_close(got[k], r, rtol=1e-5, atol=1e-7, msg=k)
        dref = (r - before[k]).double()
        dgot = (got[k] - before[k]).double()
        assert (dgot - dref).norm() <= 1e-3 * dref.norm(), k
        seen = max(seen, (dref.abs() / (1e-5 * r.double().abs() + 1e-7)
                          ).max().item())
    assert seen > 10.0


def test_gaze_step_two_ranks_equals_one(tmp_path):
    batch = gaze_batch()
    valid = batch['gt_valid']
    assert valid[:GAZE_B // 2].sum() != valid[GAZE_B // 2:].sum()
    r0, r1 = run_two(tmp_path, 'gaze_step')
    from mcgaze_tpu_torch.models.mcgaze import ModelConfig, init_model
    before = init_model(ModelConfig(**SMALL), seed=3,
                        device='cpu').state_dict()
    ref_logs, ref_sd = gaze_step(_shard(batch, 0, 1, {}), ddp=False)
    assert r0['logs'] == r1['logs']
    for k in ('loss', 'grad_norm'):
        np.testing.assert_allclose(r0['logs'][k], float(ref_logs[k]),
                                   rtol=1e-5, err_msg=k)
    got = torch.load(tmp_path / 'params.pth')
    _assert_params_match(got, ref_sd, before)
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize('model', ['instblink', 'tevit'])
def test_query_step_two_ranks_equals_one(tmp_path, model):
    from mcgaze_tpu_torch.models import query_detector as pq
    cfg_kw = QUERY_TEVIT if model == 'tevit' else QUERY
    batch = query_batch(cfg_kw)
    r0, r1 = run_two(tmp_path, 'query_step' +
                     ('_tevit' if model == 'tevit' else ''))
    before = pq.init_query_model(pq.QueryDetectorConfig(**cfg_kw), seed=4,
                                 device='cpu').state_dict()
    ref_logs, ref_sd = query_step(cfg_kw, _shard(batch, 0, 1, {}),
                                  ddp=False)
    for k in ('loss', 'grad_norm', 'stage0_num_pos', 'stage1_loss_cls'):
        np.testing.assert_allclose(r0['logs'][k], float(ref_logs[k]),
                                   rtol=1e-5, err_msg=k)
        assert r0['logs'][k] == r1['logs'][k]
    got = torch.load(tmp_path / 'params.pth')
    _assert_params_match(got, ref_sd, before)
    shutil.rmtree(tmp_path)


@pytest.fixture(scope='module')
def gaze_videos(tmp_path_factory):
    """Three fabricated videos (frames written with cv2), their COCO-VID
    JSON and a seeded .pth of the tiny gaze model."""
    cv2 = pytest.importorskip('cv2')
    from mcgaze_tpu_torch.models.mcgaze import init_model
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config
    root = tmp_path_factory.mktemp('dist_eval')
    rng = np.random.RandomState(0)
    videos, annotations = [], []
    for vid, n in zip((1, 2, 3), (9, 12, 8)):
        names = []
        for f in range(n):
            name = f'{vid:03d}/{f:05d}.png'
            os.makedirs(root / 'frames' / f'{vid:03d}', exist_ok=True)
            cv2.imwrite(str(root / 'frames' / name),
                        rng.randint(0, 255, (40, 56, 3), np.uint8))
            names.append(name)
        videos.append(dict(id=vid, width=56, height=40, length=n,
                           file_names=names))
        g = rng.randn(n, 3)
        g[:, 2] = -np.abs(g[:, 2]) - 0.8
        annotations.append(dict(video_id=vid, gaze=(
            g / np.linalg.norm(g, axis=1, keepdims=True)).tolist()))
    ann = root / 'test.json'
    ann.write_text(json.dumps(dict(videos=videos, annotations=annotations)))
    cfg = apply_overrides(load_config(GAZE_CFG), EVAL_OPTS)
    model = init_model(cfg.model, seed=7, device='cpu')
    pth = root / 'model.pth'
    torch.save({'state_dict': model.state_dict(), 'meta': {'step': 0}}, pth)
    yield dict(ann=str(ann), prefix=str(root / 'frames') + '/',
               pth=str(pth))
    shutil.rmtree(root)


EVAL_OPTS = ['model.backbone_depth=26', 'model.num_stages=2',
             'model.stage_loss_weights=1.0,1.0', 'model.ffn_channels=256',
             'eval_cfg.scale=64,64', 'eval_cfg.canvas=64,64']


def test_test_cli_two_ranks_equals_one(tmp_path, gaze_videos):
    one = tmp_path / 'one.json'
    two = tmp_path / 'two.json'
    argv = [GAZE_CFG, gaze_videos['pth'], '--json', gaze_videos['ann'],
            '--root', gaze_videos['prefix'], '--eval', 'mae', '--device',
            'cpu', '--clip-batch', '2', '--cfg-options', *EVAL_OPTS]
    # both runs in single-threaded subprocesses: the same CPU kernels,
    # so the same bits
    (lone,) = run_two(tmp_path, 'test_cli',
                      *(argv[:2] + ['--out', str(one)] + argv[2:]), world=1)
    r0, r1 = run_two(tmp_path, 'test_cli',
                     *(argv[:2] + ['--out', str(two)] + argv[2:]))
    assert lone['world'] == 1 and r0['world'] == 2
    assert r0['results'] is True and r1['results'] is False
    ref = json.loads(one.read_text())
    assert [r['video_id'] for r in ref] == [1, 2, 3]
    assert json.loads(two.read_text()) == ref


def test_train_cli_mesh_and_validate_two_ranks(tmp_path, gaze_videos):
    work = tmp_path / 'work'
    argv = [GAZE_CFG, '--synthetic', '--device', 'cpu', '--mesh', '2,1',
            '--max-iters', '2', '--work-dir', str(work), '--validate',
            '--val-interval', '2', '--val-json', gaze_videos['ann'],
            '--val-root', gaze_videos['prefix'], '--log-interval', '1',
            '--cfg-options', *EVAL_OPTS, 'data_train.batch_size=2',
            'data_train.canvas=32,32']
    r0, r1 = run_two(tmp_path, 'train_cli', *argv)
    assert r0['steps'] == r1['steps'] == 2
    assert r0['loss'] == r1['loss'] and np.isfinite(r0['loss'])
    assert r0['checkpoint'] == str(work / 'ckpt_2.pth')
    assert r1['checkpoint'] is None
    assert len(r0['validation']) == 1 and r1['validation'] == []
    val = r0['validation'][0]
    assert val['step'] == 2
    assert all(np.isfinite(v) for v in val.values())
    assert sorted(os.listdir(work)) == ['ckpt_2.pth', 'ckpt_2_train.pth',
                                        'train_log.jsonl', 'val_log.jsonl']
    lines = (work / 'train_log.jsonl').read_text().splitlines()
    assert [json.loads(x)['step'] for x in lines] == [1, 2]
    shutil.rmtree(tmp_path)


# ------------------------------------------------ eval over several devices

def test_eval_devices(monkeypatch):
    from mcgaze_tpu_torch.evaluation import driver

    def fwd():
        pass

    assert driver.eval_devices(fwd) == [None]
    fwd.device = torch.device('cpu')
    assert driver.eval_devices(fwd) == [torch.device('cpu')]
    assert driver.eval_devices(fwd, ['cpu', 'meta']) == [
        torch.device('cpu'), torch.device('meta')]
    fwd.device = torch.device('cuda')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert driver.eval_devices(fwd) == [torch.device('cuda', 0),
                                        torch.device('cuda', 1)]
    monkeypatch.setattr(D, 'process_count', lambda: 2)
    assert driver.eval_devices(fwd) == [torch.device('cuda')]


def test_round_robin_over_devices_equals_one_device(gaze_videos):
    """Both drivers with their videos dealt over two device slots (both
    the CPU here) give what one device gives, in input order."""
    from mcgaze_tpu_torch.data.instblink_dataset import InstBlinkDataConfig
    from mcgaze_tpu_torch.evaluation.driver import VideoGazeEvaluator
    from mcgaze_tpu_torch.evaluation.forward import (
        ModelReplicas, bind_forward, bind_query_forward, make_eval_forward,
        make_query_eval_forward)
    from mcgaze_tpu_torch.evaluation.instblink_driver import (
        InstBlinkEvalConfig, InstBlinkVideoEvaluator)
    from mcgaze_tpu_torch.models import query_detector as pq
    from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
    from mcgaze_tpu_torch.utils.config import load_config

    with open(gaze_videos['ann']) as f:
        videos = json.load(f)['videos']
    paths = [(v['id'], [gaze_videos['prefix'] + n for n in v['file_names']])
             for v in videos]
    cfg = apply_overrides(load_config(GAZE_CFG), EVAL_OPTS)
    model, fwd, dedup = make_eval_forward(cfg.model, seed=1, device='cpu')
    assert ModelReplicas(model).on(torch.device('cpu')) is model
    ev = VideoGazeEvaluator(bind_forward(fwd, 'cpu', dedup), cfg.eval_cfg)
    one = list(ev.run_videos_from_paths(paths))
    two = list(ev.run_videos_from_paths(paths, devices=['cpu', 'cpu']))
    assert [r['video_id'] for r in two] == [1, 2, 3]
    assert json.dumps(two) == json.dumps(one)

    qcfg = pq.QueryDetectorConfig(**QUERY_TEVIT)
    qmodel = pq.init_query_model(qcfg, seed=2, device='cpu')
    forward = bind_query_forward(*make_query_eval_forward(qmodel, qcfg),
                                 'cpu')
    qev = InstBlinkVideoEvaluator(
        forward, InstBlinkEvalConfig(clip_length=3, overlap=1,
                                     max_per_img=4),
        data_cfg=InstBlinkDataConfig(scale=(96, 64), canvas=(64, 96),
                                     keep_ratio=False, with_blinks=False))
    one = list(qev.run_videos_from_paths(paths))
    two = list(qev.run_videos_from_paths(paths, devices=['cpu', 'cpu']))
    assert len(two) == 3 and all(len(tr) == 4 for tr in two)
    assert json.dumps(two) == json.dumps(one)
