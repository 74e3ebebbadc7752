"""The gaze eval entry through CUDA graphs (evaluation/forward.py::
EvalGraphs, behind `bind_forward(...).dedup`).

On the CPU: the choice between the eager forward and a graph
(`graph_path`), the graph's key (`graph_key`), the cache and the order of
eager run, capture and replay (with the capture and replay themselves
stubbed), and the CPU path, which never touches torch.cuda's graphs and
equals `fwd_dedup`.

On a card (marked `cuda`; each test skips without one): replays against
the eager `fwd_dedup` bit for bit at the benchmark's gaze shapes (32
clips, 131 unique 224 px frames, bf16), in the plain and the fused (K4,
K5) configuration, a second shape with its own graph, outputs that
survive the next call, the eager path inside `through_operators()`, the
kernels' launch counters (their wrappers' calls: a replay makes none)
beside the K1 kernels a profiler trace sees on the card, and EvalGraphs'
own counters. This file imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_eval_graph.py
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mcgaze_tpu_torch.data.transforms import IMAGENET_MEAN, normalize
from mcgaze_tpu_torch.evaluation import forward as F
from mcgaze_tpu_torch.models.mcgaze import ModelConfig
from mcgaze_tpu_torch.ops import fused_bottleneck, roi_align_cuda
from mcgaze_tpu_torch.ops import stqi_attention
from mcgaze_tpu_torch.ops.routing import through_operators
from mcgaze_tpu_torch.utils import profiling as P
# by its file's name: pytest puts tests/ on the path, and a `tests` package
# installed elsewhere may shadow this directory's
from test_torch_port_threads import one_torch_thread  # noqa: F401

SMALL = dict(backbone_depth=26, num_stages=2, channels=32, ffn_channels=64,
             num_heads=4, dyn_feat_channels=16, stage_loss_weights=(1.0, 1.0))
CUDA = torch.device('cuda')


@pytest.fixture(autouse=True)
def _empty():
    P.drain()
    yield
    P.drain()


@pytest.fixture(scope='module')
def tiny():
    """(model, fwd, fwd_dedup) of a small f32 model on the CPU."""
    return F.make_eval_forward(ModelConfig(**SMALL), device='cpu')


def _outputs(out) -> list:
    boxes, scores, gazes = out
    return [boxes, scores] + [gazes[k] for k in sorted(gazes)]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_outputs(a), _outputs(b)))


class _Ops(TorchDispatchMode):
    """Counts the calls of each operator packet."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = func.overloadpacket
        self.calls[key] = self.calls.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


# --------------------------------------------------------------- the CPU

def test_cpu_dedup_is_eager_and_touches_no_graph(tiny, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('the CPU path touched torch.cuda')
    for name in ('CUDAGraph', 'graph', 'Stream', 'current_stream'):
        monkeypatch.setattr(torch.cuda, name, refuse)
    _, fwd, fwd_dedup = tiny
    forward = F.bind_forward(fwd, 'cpu', fwd_dedup)
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 255, (9, 32, 32, 3), dtype=torch.uint8,
                           generator=g)
    sel = np.arange(7, dtype=np.int64)
    whwh = np.full((9, 4), 32.0, np.float32)
    for _ in range(3):
        got = forward.dedup(frames.numpy(), sel, whwh, 7)
        want = fwd_dedup(frames, torch.from_numpy(sel),
                         torch.from_numpy(whwh), 7)
        assert _same(got, want)
    graphs = forward.dedup.graphs
    assert not graphs.graphs and not graphs.seen


def test_forward_makes_no_tensor_from_host_data_after_its_first_call(tiny):
    """On a card such a tensor is a copy from host memory, which a capture
    refuses; the first (eager) call makes the forward's constants."""
    _, _, fwd_dedup = tiny
    args = (torch.zeros(9, 32, 32, 3, dtype=torch.uint8), torch.arange(7),
            torch.full((9, 4), 32.0))
    fwd_dedup(*args, 7)
    with _Ops() as ops:
        fwd_dedup(*args, 7)
    assert sum(ops.calls.values()) > 100
    assert torch.ops.aten.lift_fresh not in ops.calls


def test_box_constants_made_in_an_eval_call_serve_a_train_step(monkeypatch):
    """The box decoder's constants, made once, are made outside inference
    mode: a train step saves them for its backward after an eval call."""
    from mcgaze_tpu_torch import geometry
    monkeypatch.setattr(geometry, '_consts', {})
    rois = torch.tensor([[2.0, 3.0, 20.0, 30.0]])
    with torch.inference_mode():
        geometry.delta2bbox(rois, torch.zeros(1, 4))
    deltas = torch.zeros(1, 4, requires_grad=True)
    geometry.delta2bbox(rois, deltas).sum().backward()
    assert deltas.grad is not None


def test_device_const_is_made_once_a_dtype_and_device(monkeypatch):
    from mcgaze_tpu_torch import geometry
    monkeypatch.setattr(geometry, '_consts', {})
    cpu = torch.device('cpu')
    mean = geometry.device_const(IMAGENET_MEAN, torch.float32, cpu)
    assert mean is geometry.device_const(IMAGENET_MEAN, torch.float32, cpu)
    assert mean.dtype == torch.float32 and not mean.is_inference()
    wide = geometry.device_const(IMAGENET_MEAN, torch.float64, cpu)
    assert wide is not mean and wide.dtype == torch.float64
    assert torch.equal(mean, torch.from_numpy(IMAGENET_MEAN))
    assert len(geometry._consts) == 2


def test_device_normalize_is_the_host_normalisation_with_the_pad_zeroed():
    g = torch.Generator().manual_seed(3)
    imgs = torch.randint(0, 256, (3, 12, 16, 3), dtype=torch.uint8,
                         generator=g)
    whwh = torch.tensor([[16, 12, 16, 12], [10, 12, 10, 12],
                         [16, 5, 16, 5]], dtype=torch.float32)
    with torch.inference_mode():
        got = F.device_normalize(imgs, whwh)
    for img, (w, h, _, _), out in zip(imgs.numpy(), whwh.int().tolist(),
                                      got.numpy()):
        want = np.zeros_like(out)
        want[:h, :w] = normalize(img)[:h, :w]
        np.testing.assert_array_equal(out, want)


def test_graph_path_is_eager_where_a_graph_cannot_be_seen(tiny):
    model = tiny[0]
    assert F.graph_path(CUDA, model)
    assert not F.graph_path(torch.device('cpu'), model)
    with through_operators():
        assert not F.graph_path(CUDA, model)
    with _Ops():
        assert not F.graph_path(CUDA, model)
    assert F.graph_path(CUDA, model)
    model.train()
    try:
        assert not F.graph_path(CUDA, model)
    finally:
        model.eval()


def test_graph_key_follows_reassigned_tensors_not_updates_in_place():
    model = F.make_eval_forward(ModelConfig(**SMALL), device='cpu')[0]
    dicts = F.tensor_dicts(model)
    args = (torch.zeros(9, 32, 32, 3, dtype=torch.uint8),
            torch.arange(7), torch.zeros(9, 4))

    def key(t=7, a=args):
        return F.graph_key(model, dicts, a, t)
    k0 = key()
    assert key() == k0
    assert key(t=5) != k0
    assert key(a=(args[0][:8], *args[1:])) != k0
    assert key(a=(args[0], args[1].int(), args[2])) != k0
    conv = model.backbone.conv1
    with torch.no_grad():
        conv.weight.mul_(2)
    assert key() == k0
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    k1 = key()
    assert k1 != k0
    model.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()}, assign=True)
    k2 = key()
    assert k2 not in (k0, k1)
    flag = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = not flag
        assert key() != k2
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    assert key() == k2


class _Stubbed(F.EvalGraphs):
    """EvalGraphs on the CPU with the card's work replaced by a log."""

    def __init__(self, model):
        def fwd(*a):
            raise AssertionError('the stubs never run the forward')
        fwd.model_on = lambda dev: model
        super().__init__(fwd)
        self.log = []

    def _eager(self, dev, args, t):
        self.log.append(('eager', args[0].shape[0]))
        return 'eager'

    def _capture(self, dev, args, t, dicts):
        self.log.append(('capture', args[0].shape[0]))
        return args[0].shape[0]

    def _replay(self, dev, g, args):
        self.log.append(('replay', g))
        return 'replay'


@pytest.fixture
def stubbed(tiny, monkeypatch):
    monkeypatch.setattr(F, 'graph_path', lambda dev, model: True)
    return _Stubbed(tiny[0])


def _call(graphs, u, t=7):
    return graphs(torch.zeros(u, 4, 4, 3, dtype=torch.uint8),
                  torch.arange(t), torch.zeros(u, 4), t)


def test_first_call_eager_second_captures_later_replay(stubbed):
    with P.recording():
        for _ in range(4):
            with P.span('mcgaze.eval'):
                _call(stubbed, 9)
    assert stubbed.log == [('eager', 9), ('capture', 9), ('replay', 9),
                           ('replay', 9), ('replay', 9)]
    counts = list(P.drain()['counts'].values())
    names = ('eval_graph_eager', 'eval_graph_captures', 'eval_graph_replays')
    assert [{k: c[k] for k in names if k in c} for c in counts] == [
        dict(eval_graph_eager=1),
        dict(eval_graph_captures=1, eval_graph_replays=1),
        dict(eval_graph_replays=1), dict(eval_graph_replays=1)]


def test_cache_keeps_eight_graphs_least_recently_used_first(stubbed):
    def frames(keys):
        return sorted(k[1][0][0][0] for k in keys)
    for u in range(10, 20):
        _call(stubbed, u)
        _call(stubbed, u)
    assert len(stubbed.graphs) == F.MAX_GRAPHS == 8
    assert frames(stubbed.graphs) == list(range(12, 20))
    assert not stubbed.seen
    _call(stubbed, 12)                       # used again: now the newest
    for u in (30, 30, 31, 31):
        _call(stubbed, u)
    assert frames(stubbed.graphs) == [12, 15, 16, 17, 18, 19, 30, 31]
    stubbed.log.clear()
    _call(stubbed, 10)                       # dropped: eager again
    assert stubbed.log == [('eager', 10)]
    for u in range(40, 50):                  # seen once each, never captured
        _call(stubbed, u)
    assert frames(stubbed.seen) == list(range(42, 50))
    assert frames(stubbed.graphs) == [12, 15, 16, 17, 18, 19, 30, 31]


# -------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: CUDA graphs have no CPU mode')
    return CUDA


@pytest.fixture(scope='module')
def models():
    """{name: (model, fwd, fwd_dedup)} at full width in bf16 on the card,
    built on first use."""
    built = {}

    def get(name):
        if name not in built:
            fused = dict(backbone_impl='fused', fused_attention=True)
            cfg = ModelConfig(dtype='bfloat16',
                              **(fused if name == 'fused' else {}))
            built[name] = F.make_eval_forward(cfg, seed=0, device=CUDA)
        return built[name]
    yield get
    built.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _batch(clips: int, seed: int):
    """A gaze eval chunk as VideoGazeEvaluator hands it over: `clips` 7-frame
    clips at stride 4 over 4 (clips - 1) + 7 unique 224 px uint8 frames
    (on the card), the slot -> frame map and the frames' (w, h, w, h) (on
    the host)."""
    u = 4 * (clips - 1) + 7
    g = torch.Generator(device=CUDA).manual_seed(seed)
    frames = torch.randint(0, 256, (u, 224, 224, 3), dtype=torch.uint8,
                           generator=g, device=CUDA)
    sel = np.concatenate([np.arange(4 * k, 4 * k + 7)
                          for k in range(clips)])
    return frames, sel, np.full((u, 4), 224.0, np.float32)


def _eager(fwd_dedup, frames, sel, whwh):
    return fwd_dedup(frames, torch.from_numpy(sel).to(CUDA),
                     torch.from_numpy(whwh).to(CUDA), 7)


def _check_bitwise(model_fwd, batches):
    _, fwd, fwd_dedup = model_fwd
    forward = F.bind_forward(fwd, CUDA, fwd_dedup)
    for b in batches:
        got = forward.dedup(*b, 7)
        want = _eager(fwd_dedup, *b)
        assert _same(got, want)
    return forward


@pytest.mark.cuda
def test_replays_equal_eager_bit_for_bit_at_the_cells_shape(cuda_device,
                                                            models):
    forward = _check_bitwise(models('plain'),
                             [_batch(32, s) for s in range(3)])
    assert len(forward.dedup.graphs.graphs) == 1


@pytest.mark.cuda
def test_second_shape_gets_its_own_graph(cuda_device, models):
    _, fwd, fwd_dedup = models('plain')
    forward = F.bind_forward(fwd, CUDA, fwd_dedup)
    for seed in range(2):
        for clips in (32, 4):
            b = _batch(clips, seed)
            assert _same(forward.dedup(*b, 7), _eager(fwd_dedup, *b))
    assert len(forward.dedup.graphs.graphs) == 2
    b = _batch(4, 7)
    assert _same(forward.dedup(*b, 7), _eager(fwd_dedup, *b))


@pytest.mark.cuda
def test_outputs_survive_the_next_call(cuda_device, models):
    _, fwd, fwd_dedup = models('plain')
    forward = F.bind_forward(fwd, CUDA, fwd_dedup)
    outs, kept = [], []
    for seed in range(4):
        out = forward.dedup(*_batch(32, seed), 7)
        outs.append(out)
        kept.append([t.clone() for t in _outputs(out)])
    torch.cuda.synchronize()
    for out, snap in zip(outs, kept):
        assert all(torch.equal(a, b) for a, b in zip(_outputs(out), snap))
    assert not _same(outs[2], outs[3])


@pytest.mark.cuda
def test_fused_configuration_replays_equal_eager(cuda_device, models):
    k4, k5 = stqi_attention.launch_count, fused_bottleneck.launch_count
    _check_bitwise(models('fused'), [_batch(32, s) for s in range(3)])
    # the wrappers ran in 3 eager calls, the first bound call and the
    # capture (the third bound call replays): 4 K4 and 40 K5 a forward
    assert stqi_attention.launch_count - k4 == 5 * 4
    assert fused_bottleneck.launch_count - k5 == 5 * 40


@pytest.mark.cuda
def test_through_operators_runs_eagerly(cuda_device, models):
    _, fwd, fwd_dedup = models('plain')
    forward = F.bind_forward(fwd, CUDA, fwd_dedup)
    b = _batch(32, 0)
    for _ in range(2):
        forward.dedup(*b, 7)
    assert len(forward.dedup.graphs.graphs) == 1
    with P.recording(), through_operators(), _Ops() as ops:
        got = forward.dedup(*b, 7)
    (counts,) = P.drain()['counts'].values()
    assert ops.calls[torch.ops.mcgaze.roi_align_fpn] == 4
    assert counts['eval_graph_eager'] == 1
    assert 'eval_graph_replays' not in counts
    assert _same(got, _eager(fwd_dedup, *b))


def _kernels_on_card(fn, name: str) -> int:
    """How many kernels named `name` the card ran in fn(), counted in a
    CUDA-only profiler trace (which sees a replayed graph's kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and name in ev.key)


@pytest.mark.cuda
def test_launch_and_graph_counters(cuda_device, models):
    """The K1 wrapper counts 4 launches on the eager call and on the
    capture, none on a replay; the card runs 4 K1 kernels on every call."""
    _, fwd, fwd_dedup = models('plain')
    forward = F.bind_forward(fwd, CUDA, fwd_dedup)
    moved, ran = [], []
    with P.recording():
        for seed in range(4):
            b = _batch(32, seed)
            before = roi_align_cuda.launch_count
            ran.append(_kernels_on_card(lambda: forward.dedup(*b, 7),
                                        'roi_align_fpn_kernel'))
            moved.append(roi_align_cuda.launch_count - before)
    assert moved == [4, 4, 0, 0]
    assert ran == [4, 4, 4, 4]
    rec = P.drain()
    counts = [rec['counts'][s['call']] for s in rec['spans']
              if s['parent'] is None]
    names = ('eval_graph_eager', 'eval_graph_captures', 'eval_graph_replays')
    assert [{k: c[k] for k in names if k in c} for c in counts] == [
        dict(eval_graph_eager=1),
        dict(eval_graph_captures=1, eval_graph_replays=1),
        dict(eval_graph_replays=1), dict(eval_graph_replays=1)]
    assert [c['launch_count.k1'] for c in counts] == [4, 4, 0, 0]
    replayed = [s['name'] for s in rec['spans']
                if s['call'] == rec['spans'][-1]['call']]
    assert replayed == ['mcgaze.eval', 'mcgaze.handover',
                        'mcgaze.eval_graph']
