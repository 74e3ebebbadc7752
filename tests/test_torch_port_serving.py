"""The port's serving stack against the JAX package's.

* Requests: one reference-named .pth of a seeded port model (R26, FFN 256,
  4 stages: the JAX build_forward converts a .pth with four; 64 px canvas;
  clip batch 2) serves through the port's GazeRequestProcessor (built by
  the serve CLI, --device cpu) and the JAX one. A raw PNG, a 7-frame, a
  3-frame and a 12-frame JSON body (the last takes the video path) give
  the same responses at 1e-3, the model parity tolerance: boxes relative
  to their largest coordinate, scores and gazes absolutely; which clue
  entries pass score_thr is compared only where the JAX score lies more
  than 1e-3 from it.
* The micro-batcher with fake forwards, as tests/test_serving.py holds the
  JAX one: it fuses and pads to pow2, surfaces errors to every waiter, a
  stopped batcher fails requests instead of hanging, warmup runs the burst
  bucket of a non-pow2 max_batch and the video path, the ship dtype
  follows accepts_uint8. Each has a time bound, so a hang fails fast.
* HTTP in process: package_model -> resolve_package -> the serve CLI's
  processor -> make_server in a thread: ping, models, 404, 400 on an
  undecodable body, a served response equal to the local one, and the
  test_server CLI against it. publish_model on a .pth (hash suffix, no
  optimizer, --ema). Orbax directories are refused.
* Export: export_model on the CPU, --selftest, the saved program equal to
  the eager forward at 1e-5 on other inputs, with the FPN RoIAlign as one
  mcgaze::roi_align_fpn node per stage; the fused configuration exports
  with its K4 and K5 operator nodes.
* Kernel loading: threads reaching a library's first load together build
  and load it once.
* The CLIs default to the card and refuse without one.
"""
import base64
import functools
import json
import os
import os.path as osp
import shutil
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mcgaze_tpu_torch.evaluation import serving as pserving
from mcgaze_tpu_torch.evaluation.driver import EvalConfig
from mcgaze_tpu_torch.models.mcgaze import init_model
from mcgaze_tpu_torch.ops import _native
from mcgaze_tpu_torch.tools.deployment import (export_model, package_model,
                                               serve, test_server)
from mcgaze_tpu_torch.tools.model_converters import publish_model
from mcgaze_tpu_torch.utils.cfg_options import apply_overrides
from mcgaze_tpu_torch.utils.config import load_config
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(REPO, 'configs', 'multiclue_gaze',
                  'multiclue_gaze_r50_gaze360.py')
OPTS = ['model.backbone_depth=26', 'model.ffn_channels=256',
        'eval_cfg.scale=64,64', 'eval_cfg.canvas=64,64',
        'eval_cfg.clip_batch=2']
TOL = 1e-3
SCORE_THR = 0.5
FRAME_HW = (72, 96)


def bounded(seconds):
    """Fail the test when it has not finished within `seconds`: a hung
    batcher would otherwise hold the suite's clock."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def target():
                try:
                    box['value'] = fn(*args, **kwargs)
                except BaseException as e:  # re-raised in the test thread
                    box['error'] = e

            th = threading.Thread(target=target, daemon=True)
            th.start()
            th.join(seconds)
            if th.is_alive():
                pytest.fail(f'{fn.__name__} did not finish in {seconds} s')
            if 'error' in box:
                raise box['error']
        return run
    return wrap


def encode_png(img: np.ndarray) -> bytes:
    import cv2
    ok, buf = cv2.imencode('.png', cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def json_body(frames) -> bytes:
    return json.dumps({'frames': [base64.b64encode(encode_png(f)).decode()
                                  for f in frames]}).encode()


def fake_outputs(n, value=0.0):
    z = torch.full((n, 3), float(value))
    return (torch.full((n, 3, 4), float(value)), z,
            {m: z for m in ('fusion', 'face', 'eyes', 'head')})


# ------------------------------------------------------------- the model

@pytest.fixture(scope='module')
def ws(tmp_path_factory):
    """The .pth of a seeded port model (its proposals, norms and biases
    spread; class biases put face and head above the threshold and eyes
    below it), request bodies, and the serve CLI's port processor."""
    root = str(tmp_path_factory.mktemp('port_serving'))
    cfg = apply_overrides(load_config(CONFIG), OPTS)
    model = init_model(cfg.model, seed=7, device='cpu')
    gen = torch.Generator().manual_seed(8)
    cls_bias = dict(face=1.0, eyes=-1.0, head=1.0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('init_proposal_bboxes.weight'):
                p.copy_(torch.rand(p.shape, generator=gen) * 0.4 + 0.3)
            elif p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
            if name.endswith('_fc_cls.bias'):
                p.add_(cls_bias[name.split('.')[-2][:-len('_fc_cls')]])
    pth = osp.join(root, 'model.pth')
    torch.save({'state_dict': model.state_dict(), 'meta': {'step': 0},
                'optimizer': {'m': torch.zeros(3)}}, pth)

    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 255, (*FRAME_HW, 3), np.uint8)
              for _ in range(12)]
    img_path = osp.join(root, 'img.png')
    with open(img_path, 'wb') as f:
        f.write(encode_png(frames[0]))
    bodies = dict(raw=(encode_png(frames[0]), 'application/octet-stream'),
                  json7=(json_body(frames[:7]), 'application/json'),
                  json3=(json_body(frames[3:6]), 'application/json'),
                  json12=(json_body(frames), 'application/json'))

    pkg = package_model.main([CONFIG, pth, '--output-folder',
                              osp.join(root, 'pkgs'), '--model-name',
                              'tinygaze'])
    proc = serve.build_processor(serve.parse_args(
        [pkg, '--device', 'cpu', '--cfg-options', *OPTS]))
    yield dict(root=root, pth=pth, pkg=pkg, bodies=bodies, frames=frames,
               img=img_path, proc=proc)
    proc.close()
    shutil.rmtree(root)     # the .pth and its package


@pytest.fixture(scope='module')
def jax_proc(ws):
    """The JAX processor on the same .pth (its build_forward converts it)."""
    from mcgaze_tpu.evaluation.serving import GazeRequestProcessor
    from mcgaze_tpu.evaluation.serving import ServeConfig as JServeConfig
    from mcgaze_tpu.utils.cfg_options import apply_overrides as japply
    from mcgaze_tpu.utils.config import load_config as jload
    from tools.test_gaze360_gaze import build_forward as jbuild

    cfg = japply(jload(CONFIG), OPTS)
    proc = GazeRequestProcessor(jbuild(cfg, ws['pth']), cfg.eval_cfg,
                                JServeConfig(score_thr=SCORE_THR))
    yield proc
    proc.close()


def assert_entries_match(ours: list, ref: list, ref_scores: dict):
    """Handler-style lists: the fusion gaze always; a clue entry where
    both have it; a clue only one of them has only where the JAX score is
    within TOL of the threshold. Returns how many clue entries compared."""
    mine = {e['class_name']: e for e in ours}
    theirs = {e['class_name']: e for e in ref}
    assert ours[-1]['class_name'] == ref[-1]['class_name'] == 'fusion'
    np.testing.assert_allclose(ours[-1]['gaze'], ref[-1]['gaze'], rtol=0,
                               atol=TOL)
    compared = 0
    for clue in pserving.CLUES:
        if (clue in mine) != (clue in theirs):
            assert abs(ref_scores[clue] - SCORE_THR) <= TOL, (clue, mine,
                                                              theirs)
            continue
        if clue not in mine:
            continue
        a, b = mine[clue], theirs[clue]
        scale = max(np.abs(b['bbox']).max(), 1.0)
        np.testing.assert_allclose(np.asarray(a['bbox']) / scale,
                                   np.asarray(b['bbox']) / scale, rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(a['score'], b['score'], rtol=0, atol=TOL)
        np.testing.assert_allclose(a['gaze'], b['gaze'], rtol=0, atol=TOL)
        compared += 1
    return compared


def jax_scores(jax_proc, frames):
    """The JAX clip path's unfiltered per-frame scores, by clue."""
    _, scores, _ = jax_proc._forward_clip(frames)
    return [dict(zip(pserving.CLUES, map(float, s))) for s in scores]


def test_requests_match_jax(ws, jax_proc):
    from test_torch_port_cli import assert_results_match

    proc, bodies, frames = ws['proc'], ws['bodies'], ws['frames']
    compared = 0
    body, ctype = bodies['raw']
    ours, ref = proc.process_body(body, ctype), jax_proc.process_body(
        body, ctype)
    compared += assert_entries_match(
        ours, ref, jax_scores(jax_proc, [frames[0]] * 7)[0])
    for key, clip in (('json7', frames[:7]), ('json3', frames[3:6])):
        ours = proc.process_body(*bodies[key])
        ref = jax_proc.process_body(*bodies[key])
        assert len(ours['frames']) == len(ref['frames']) == len(clip)
        np.testing.assert_allclose(ours['fusion_gazes'], ref['fusion_gazes'],
                                   rtol=0, atol=TOL)
        for a, b, s in zip(ours['frames'], ref['frames'],
                           jax_scores(jax_proc, clip)):
            compared += assert_entries_match(a, b, s)
    assert compared >= 10, 'too few clue entries compared'

    ours = proc.process_body(*bodies['json12'])
    ref = jax_proc.process_body(*bodies['json12'])
    assert ours['category_id'] == ref['category_id'] == 1
    assert len(ours['fusion_gazes']) == 12
    ours['video_id'] = ref['video_id']
    assert_results_match([ours], [ref])


# ------------------------------------------------------ the micro-batcher

@bounded(60)
def test_micro_batcher_fuses_and_pads():
    t, calls = 3, []

    def fake_forward(imgs, whwh, tt):
        assert tt == t
        k = imgs.shape[0] // t
        assert k & (k - 1) == 0, f'clip count {k} not pow2-padded'
        calls.append(k)
        # row marker = mean pixel, so routing is checkable per request
        marker = imgs.float().mean(dim=(1, 2, 3))
        return (marker[:, None, None].expand(-1, 3, 4),
                marker[:, None].expand(-1, 3),
                {n: marker[:, None].expand(-1, 3)
                 for n in ('fusion', 'face', 'eyes', 'head')})

    mb = pserving.MicroBatcher(fake_forward, clip_length=t, max_batch=4,
                               timeout_ms=300.0)
    try:
        results = {}

        def call(i):
            results[i] = mb.submit(np.full((t, 4, 4, 3), float(i),
                                           np.float32),
                                   np.ones((t, 4), np.float32))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
            assert not th.is_alive()
        for i in range(3):
            boxes, scores, gazes = results[i]
            assert boxes.shape == (t, 3, 4)
            np.testing.assert_allclose(boxes, float(i))
            np.testing.assert_allclose(gazes['fusion'], float(i))
        # 3 concurrent requests in a 300 ms window coalesce, padded to 4
        assert sum(mb.batch_sizes) == 3 and len(calls) < 3, calls
        assert all(k in (1, 2, 4) for k in calls)
        with pytest.raises(ValueError):
            mb.submit(np.zeros((t + 1, 4, 4, 3), np.float32),
                      np.ones((t + 1, 4), np.float32))
    finally:
        mb.stop()


@bounded(30)
def test_micro_batcher_surfaces_errors_to_every_waiter():
    def broken(imgs, whwh, t):
        raise RuntimeError('device on fire')

    mb = pserving.MicroBatcher(broken, clip_length=2, max_batch=4,
                               timeout_ms=200.0)
    try:
        errors = []

        def call():
            try:
                mb.submit(np.zeros((2, 4, 4, 3), np.float32),
                          np.ones((2, 4), np.float32))
            except RuntimeError as e:
                errors.append(str(e))

        threads = [threading.Thread(target=call) for _ in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(20)
            assert not th.is_alive()
        assert errors == ['device on fire'] * 3
    finally:
        mb.stop()


@bounded(30)
def test_stopped_batcher_fails_requests_instead_of_hanging():
    mb = pserving.MicroBatcher(lambda imgs, whwh, t: fake_outputs(
        imgs.shape[0]), clip_length=2, max_batch=2, timeout_ms=1.0)
    mb.stop()
    with pytest.raises(RuntimeError):
        mb.submit(np.zeros((2, 4, 4, 3), np.float32),
                  np.ones((2, 4), np.float32))
    # a request that slipped into the queue around stop() is failed by
    # stop()'s drain rather than left waiting
    done = threading.Event()
    slot = {}
    mb._queue.put((torch.zeros(2, 4, 4, 3), np.ones((2, 4), np.float32),
                   done, slot))
    mb.stop()
    assert done.is_set() and isinstance(slot['error'], RuntimeError)


@bounded(60)
def test_warmup_covers_burst_bucket_and_video_path():
    """Clip buckets up to next_pow2(max_batch) (6 -> the 8-bucket that a
    full burst pads to), served by the batcher's worker thread; then one
    video per pow2 chunk up to clip_batch, on a thread of its own (not the
    caller's); a time per bucket."""
    t, seen_k, threads = 2, [], []

    def fake_forward(imgs, whwh, tt):
        seen_k.append(imgs.shape[0] // tt)
        threads.append(threading.current_thread())
        return fake_outputs(imgs.shape[0])

    eval_cfg = EvalConfig(scale=(16, 16), canvas=(16, 16), clip_length=t,
                          stride=1, clip_batch=4)
    proc = pserving.GazeRequestProcessor(fake_forward, eval_cfg,
                                         pserving.ServeConfig(max_batch=6))
    try:
        seconds = proc.warmup()
        assert seen_k == [1, 2, 4, 8, 1, 2, 4]
        assert threads[:4] == [proc.batcher._worker] * 4
        assert threading.current_thread() not in threads
        assert len(set(threads[4:])) == 1
        assert proc.batcher.batch_sizes == [1, 2, 4, 8]
        assert list(seconds) == ['clip_1', 'clip_2', 'clip_4', 'clip_8',
                                 'video_1', 'video_2', 'video_4']
        assert all(s >= 0 for s in seconds.values())
    finally:
        proc.close()


@bounded(60)
def test_ship_dtype_follows_forward_capability():
    """A forward that normalises on the device (accepts_uint8) receives
    raw u8 frames; a plain f32 forward receives normalised f32."""
    seen = {}

    def fake_forward(imgs, whwh, t):
        seen['dtype'] = imgs.dtype
        return fake_outputs(imgs.shape[0])

    eval_cfg = EvalConfig(scale=(16, 16), canvas=(16, 16), clip_length=2)
    frame = np.zeros((20, 20, 3), np.uint8)
    for accepts, dtype in ((False, torch.float32), (True, torch.uint8)):
        fake_forward.accepts_uint8 = accepts
        proc = pserving.GazeRequestProcessor(fake_forward, eval_cfg)
        try:
            assert proc.ship_u8 is accepts
            proc.process_frames([frame, frame])
            assert seen['dtype'] == dtype
        finally:
            proc.close()


# ------------------------------------------------------------------ HTTP

def _http(method, port, path, body=None, content_type=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}', data=body, method=method,
        headers={'Content-Type': content_type} if content_type else {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@bounded(300)
def test_packaged_model_over_http(ws):
    from mcgaze_tpu_torch.evaluation.serving import make_server

    pkg, proc = ws['pkg'], ws['proc']
    manifest = json.load(open(osp.join(pkg, 'MANIFEST.json')))
    assert manifest['runtime'] == 'torch-cuda'
    assert manifest['model_name'] == proc.cfg.model_name == 'tinygaze'
    assert pserving.resolve_package(pkg) == (
        osp.join(pkg, 'config.py'), osp.join(pkg, 'model.pth'), 'tinygaze')
    assert pserving.resolve_package(ws['root']) is None

    server = make_server(proc, '127.0.0.1', 0)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        assert _http('GET', port, '/ping') == (200, {'status': 'Healthy'})
        status, data = _http('GET', port, '/models')
        assert status == 200
        assert data['models'][0]['modelName'] == 'tinygaze'
        assert _http('GET', port, '/nope')[0] == 404
        body, ctype = ws['bodies']['raw']
        assert _http('POST', port, '/predictions/other', body, ctype)[0] \
            == 404
        status, data = _http('POST', port, '/predictions/tinygaze',
                             b'garbage', 'application/octet-stream')
        assert status == 400 and 'error' in data
        assert _http('GET', port, '/ping')[0] == 200

        status, served = _http('POST', port, '/predictions/tinygaze', body,
                               ctype)
        assert status == 200
        local = proc.process_body(body, ctype)
        assert test_server.assert_same(local, served, 1e-4) <= 1e-4
        status, clip = _http('POST', port, '/predictions/tinygaze',
                             *ws['bodies']['json3'])
        assert status == 200 and len(clip['frames']) == 3

        # the test_server CLI: its own local model against the server
        out = test_server.main([ws['img'], CONFIG, ws['pth'], 'tinygaze',
                                '--inference-addr', f'127.0.0.1:{port}',
                                '--device', 'cpu', '--cfg-options', *OPTS])
        assert out['max_abs_diff'] <= 1e-4
        assert [e['class_name'] for e in out['served']] == \
            [e['class_name'] for e in served]
    finally:
        server.shutdown()
        server.server_close()
        th.join(10)


def test_package_model_options(ws, tmp_path):
    ckpt = str(tmp_path / 'ckpt_2.pth')
    torch.save({'state_dict': {'w': torch.ones(3)}}, ckpt)
    torch.save({'ema': {'w': torch.full((3,), 2.0)}},
               str(tmp_path / 'ckpt_2_train.pth'))
    out = str(tmp_path / 'pkgs')
    pkg = package_model.main([CONFIG, ckpt, '--output-folder', out,
                              '--model-version', '2.0', '--archive'])
    assert osp.basename(pkg) == 'ckpt_2'
    assert osp.isfile(osp.join(pkg, 'ckpt_2_train.pth'))  # the EMA split
    assert json.load(open(osp.join(pkg, 'MANIFEST.json')))['version'] == \
        '2.0'
    assert osp.isfile(osp.join(out, 'ckpt_2.mar'))
    with pytest.raises(SystemExit, match='exists'):
        package_model.main([CONFIG, ckpt, '--output-folder', out])
    package_model.main([CONFIG, ckpt, '--output-folder', out, '-f'])
    orbax = str(tmp_path / 'ckpt_7')
    os.makedirs(orbax)
    with pytest.raises(SystemExit, match='torch .pth'):
        package_model.main([CONFIG, orbax, '--output-folder', out])


def test_publish_model_pth(ws, tmp_path):
    final = publish_model.main([ws['pth'], str(tmp_path / 'rel' / 'mcg')])
    name = osp.basename(final)
    assert name.startswith('mcg-') and name.endswith('.pth')
    sha = publish_model.sha256_file(final)
    assert name == f'mcg-{sha[:8]}.pth'
    ckpt = torch.load(final)
    assert 'optimizer' not in ckpt and set(ckpt) == {'state_dict', 'meta'}
    src = torch.load(ws['pth'])['state_dict']
    assert all(torch.equal(ckpt['state_dict'][k], v) for k, v in src.items())

    # --ema: the train split's EMA weights in place of the parameters
    ckpt_in = str(tmp_path / 'ckpt_3.pth')
    torch.save({'state_dict': {'w': torch.ones(3), 'bn': torch.zeros(2)},
                'optimizer': {}}, ckpt_in)
    torch.save({'ema': {'w': torch.full((3,), 2.0)}, 'step': 3},
               str(tmp_path / 'ckpt_3_train.pth'))
    ema = torch.load(publish_model.main([ckpt_in, str(tmp_path / 'ema'),
                                         '--ema']))['state_dict']
    assert torch.equal(ema['w'], torch.full((3,), 2.0))
    assert torch.equal(ema['bn'], torch.zeros(2))
    torch.save({'ema': None}, str(tmp_path / 'ckpt_3_train.pth'))
    with pytest.raises(SystemExit, match='ema_momentum > 0'):
        publish_model.main([ckpt_in, str(tmp_path / 'x'), '--ema'])
    orbax = str(tmp_path / 'ckpt_7')
    os.makedirs(orbax)
    with pytest.raises(SystemExit, match='torch .pth'):
        publish_model.main([orbax, str(tmp_path / 'y')])
    shutil.rmtree(tmp_path)


# ---------------------------------------------------------------- export

EXPORT_OPTS = ['model.backbone_depth=26', 'model.ffn_channels=256',
               'model.num_stages=2', 'model.stage_loss_weights=1.0,1.0',
               'eval_cfg.scale=64,64', 'eval_cfg.canvas=64,64']


def test_export_matches_eager(tmp_path):
    out = str(tmp_path / 'model.pt2')
    res = export_model.main([CONFIG, '--out', out, '--selftest', '--device',
                             'cpu', '--cfg-options', *EXPORT_OPTS])
    assert res['selftest_max_abs_err'] <= export_model.SELFTEST_ATOL
    targets = [str(nd.target) for nd in res['program'].graph.nodes
               if nd.op == 'call_function']
    assert targets.count('mcgaze.roi_align_fpn.default') == 2  # per stage

    # the loaded program on inputs it was not traced with, against the
    # eager forward of the same frozen weights (on the CPU, weights that
    # need a gradient take other conv kernels, ~3e-5 relative apart)
    cfg = apply_overrides(load_config(CONFIG), EXPORT_OPTS)
    eager = export_model.ClipForward(
        init_model(cfg.model, seed=0, device='cpu').requires_grad_(False),
        7).eval()
    imgs, whwh = export_model.example_inputs(7, 64, 64, 'cpu', seed=1)
    whwh[:, [0, 2]] = 48.0
    loaded = torch.export.load(out).module()
    with torch.inference_mode():
        for a, b in zip(loaded(imgs, whwh), eager(imgs, whwh)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    shutil.rmtree(tmp_path)


def test_export_fused_configuration(tmp_path):
    """The CLI exports the fused configuration with --selftest, K4 and K5
    as operator nodes beside K1's (held against the JAX fused forward in
    tests/test_torch_port_fused.py)."""
    opts = EXPORT_OPTS + ['model.backbone_impl=fused',
                          'model.fused_attention=True']
    out = str(tmp_path / 'f.pt2')
    res = export_model.main([CONFIG, '--out', out, '--selftest', '--device',
                             'cpu', '--cfg-options', *opts])
    assert osp.exists(out)
    assert res['selftest_max_abs_err'] <= export_model.SELFTEST_ATOL
    targets = [str(nd.target) for nd in res['program'].graph.nodes
               if nd.op == 'call_function']
    assert targets.count('mcgaze.roi_align_fpn.default') == 2   # per stage
    assert targets.count('mcgaze.stqi_attention.default') == 2  # per stage
    # R26 has one block a stage: only layer1's is a stride-1 chain
    assert targets.count('mcgaze.fused_bottleneck_chain.default') == 1
    shutil.rmtree(tmp_path)


# --------------------------------------------------------- kernel loading

@bounded(60)
def test_kernel_library_built_and_loaded_once(monkeypatch, tmp_path):
    """Threads that reach a library's first launch together build it and
    load it once (a server launches from its batcher and its request
    threads)."""
    lib_path = tmp_path / 'libroi_align_fpn-0.so'
    builds, loads = [], []

    def fake_start(name):
        builds.append(name)
        time.sleep(0.05)
        return None, None, None

    def fake_finish(name, proc, tmp, out):
        lib_path.write_bytes(b'')
        return ''

    class FakeLib:
        def __init__(self, path):
            loads.append(path)
            time.sleep(0.01)
            self.mcg_cuda_error_string = lambda err: b''

    monkeypatch.setattr(_native, 'library_path', lambda name: lib_path)
    monkeypatch.setattr(_native, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(_native, '_start', fake_start)
    monkeypatch.setattr(_native, '_finish', fake_finish)
    monkeypatch.setattr(_native.ctypes, 'CDLL', FakeLib)
    monkeypatch.setattr(_native, '_loaded', {})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(8)
        got = []

        def first_launch():
            barrier.wait()
            got.append(_native.load('roi_align_fpn'))

        threads = [threading.Thread(target=first_launch) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(20)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert builds == ['roi_align_fpn'] and loads == [str(lib_path)]
    assert len(got) == 8 and all(lib is got[0] for lib in got)


# ---------------------------------------------------------------- device

def test_clis_refuse_cuda_without_card(ws, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    cases = (
        lambda: serve.main([ws['pkg'], '--cfg-options', *OPTS]),
        lambda: test_server.main([ws['img'], CONFIG, ws['pth'], 'tinygaze',
                                  '--cfg-options', *OPTS]),
        lambda: export_model.main([CONFIG, '--out', str(tmp_path / 'm.pt2'),
                                   '--cfg-options', *EXPORT_OPTS]),
    )
    for run in cases:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    assert not osp.exists(tmp_path / 'm.pt2')
