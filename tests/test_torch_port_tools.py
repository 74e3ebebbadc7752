"""The port's tools and their utilities (ROADMAP item 14) on the CPU,
against the JAX package's where both compute the same thing:

  * utils/collect_env.py: the JAX report's core fields, the same values
    where both read the same library;
  * utils/benchmarking.py::serial_chain_time: warmup + iters x repeats
    calls, each fed the last one's output, a positive time;
  * utils/profiling.py: profile_time, trace and IterTimer as
    tests/test_profiling.py asks of the JAX ones; cost_analysis counts a
    128^3 matmul as 2*128^3, the tiny gaze forward as the sum over its
    convolutions and products written out below, each kernel operator as
    tools/kernel_bounds.py counts its work, and refuses a kernel launched
    outside its operator; the JAX package's XLA figure for the same
    forward is printed, not asserted (XLA counts elementwise work too);
  * tools.misc.print_config, tools.analysis_tools.analyze_logs: the JAX
    tools' output on the same inputs; visualize_results and browse_dataset:
    PNGs byte-equal to the JAX tools';
  * every tool that drives the model runs at a tiny size with --device
    cpu and prints lines that parse (benchmark also on .npy frames, as the
    card's machine runs it), and refuses --device cuda without a card;
  * roi_kernel_check: the JAX tool's inputs bit for bit, its four cases a
    shape at small shapes on the CPU, a breach reported and exit 1;
  * tools/train.py --profile-dir leaves a trace; the six shell wrappers.

Every file a test writes is removed at its end.
"""
import contextlib
import importlib.util
import io
import json
import math
import os
import os.path as osp
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

from mcgaze_tpu_torch.models.heads import BLOCK_ROWS
from mcgaze_tpu_torch.models.mcgaze import ModelConfig, init_model
from mcgaze_tpu_torch.ops import (fused_bottleneck, roi_align_cuda,
                                  stqi_attention)
from mcgaze_tpu_torch.ops.roi_align import (roi_align_fpn_mm,
                                            roi_align_fpn_mm_bwd, roi_levels)
from mcgaze_tpu_torch.tools import kernel_bounds
from mcgaze_tpu_torch.tools.analysis_tools import (analyze_logs,
                                                   backbone_bench, benchmark,
                                                   dedup_bench, get_flops,
                                                   npy_frames,
                                                   roi_kernel_check,
                                                   serve_bench,
                                                   step_breakdown,
                                                   train_bench,
                                                   visualize_results)
from mcgaze_tpu_torch.tools.misc import browse_dataset, print_config
from mcgaze_tpu_torch.utils import profiling
from mcgaze_tpu_torch.utils.benchmarking import serial_chain_time
from mcgaze_tpu_torch.utils.collect_env import collect_env

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CFG_DIR = osp.join(ROOT, 'configs')
GAZE360 = osp.join(CFG_DIR, 'multiclue_gaze', 'multiclue_gaze_r50_gaze360.py')
SHIPPED = dict(
    gaze360=GAZE360,
    l2cs=osp.join(CFG_DIR, 'multiclue_gaze', 'multiclue_gaze_r50_l2cs.py'),
    instblink=osp.join(CFG_DIR, 'instblink', 'instblink_r50_mpeblink.py'),
    tevit=osp.join(CFG_DIR, 'tevit', 'tevit_msgshift_youtubevis.py'))
TINY = ['model.backbone_depth=26', 'model.num_stages=2',
        'model.stage_loss_weights=1.0,1.0', 'model.ffn_channels=256']
TINY_EVAL = TINY + ['eval_cfg.scale=64,64', 'eval_cfg.canvas=64,64']
TINY_CFG = ModelConfig(backbone_depth=26, num_stages=2,
                       stage_loss_weights=(1.0, 1.0), ffn_channels=256)


def jax_tool(path):
    """A JAX package tool module, loaded from its path under tools/."""
    name = 'jax_' + osp.splitext(osp.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        name, osp.join(ROOT, 'tools', path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(path, argv, monkeypatch):
    """The JAX tool's main() with sys.argv set; its stdout."""
    mod = jax_tool(path)
    monkeypatch.setattr(sys, 'argv', [path] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def run_main(main, argv):
    """A port main(argv) and its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return ret, out.getvalue()


def json_lines(text):
    """Every stdout line that is a JSON object, parsed."""
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith('{')]


def all_finite(obj):
    if isinstance(obj, dict):
        return all(all_finite(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(all_finite(v) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return math.isfinite(obj)
    return True


# -------------------------------------------------------------- utilities

def test_collect_env_reports_core_fields():
    """The JAX report's core fields (tests/test_misc_tools.py asks for the
    framework, the devices and the native loader); python, platform,
    numpy and cv2 read as the JAX report reads them."""
    from mcgaze_tpu.utils.collect_env import collect_env as jax_env
    info = collect_env()
    for key in ('torch', 'cuda', 'devices', 'nvcc', 'native_loader',
                'cuda_kernels', 'cudnn', 'scipy', 'triton'):
        assert key in info and info[key], key
    assert info['torch'] == torch.__version__
    if not torch.cuda.is_available():
        assert info['cuda'] == 'not available'
    ref = jax_env()
    for key in ('python', 'platform', 'numpy', 'cv2', 'native_loader'):
        assert info[key].split(' (')[0] == ref[key].split(' (')[0], key
    from mcgaze_tpu_torch.utils import collect_env as mod
    _, out = run_main(mod.main, [])
    assert 'cuda: ' in out and 'cuda_kernels: ' in out


@pytest.mark.parametrize('warmup,iters,repeats', [(3, 5, 1), (0, 4, 3)])
def test_serial_chain_time_chains_and_counts(warmup, iters, repeats):
    seen, returned = [], []

    def fn(eps):
        assert eps.dtype == torch.float32 and eps.dim() == 0
        seen.append(eps)
        out = eps + 1.0
        returned.append(out)
        return out

    dt = serial_chain_time(fn, iters, warmup, repeats)
    assert dt > 0
    assert len(seen) == warmup + iters * repeats
    # each call gets the one before's output, the chains start from 0
    starts = [0] + [warmup + i * iters for i in range(repeats)]
    for i in range(len(seen)):
        if i in starts:
            assert float(seen[i]) == 0.0
        else:
            assert seen[i] is returned[i - 1]


def test_profile_time_records_elapsed(capsys):
    a = torch.ones(8, 8)
    with profiling.profile_time('blk', log=True) as box:
        box['sync'] = a @ a
    assert box['elapsed'] > 0
    assert 'blk:' in capsys.readouterr().out
    with profiling.profile_time('quiet', log=False, sync=[a],
                                stream=object()) as box:
        pass
    assert box['elapsed'] >= 0 and capsys.readouterr().out == ''


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / 'prof'
    with profiling.trace(str(d)):
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = list(d.iterdir())
    assert len(files) == 1 and files[0].suffix == '.json'
    events = json.loads(files[0].read_text())['traceEvents']
    assert any('mm' in str(e.get('name', '')) for e in events)
    shutil.rmtree(tmp_path)


def test_iter_timer_accounting():
    timer = profiling.IterTimer()
    timer.before_iter()
    timer.after_iter(sync=torch.ones(2))
    assert timer.time >= 0
    timer.before_iter()
    assert timer.data_time >= 0


# ---------------------------------------------------------- cost analysis

def test_cost_analysis_matmul_flops():
    a = torch.ones(128, 128)
    ca = profiling.cost_analysis(lambda x, y: x @ y, a, a)
    assert ca['flops'] == 2 * 128 ** 3
    assert ca['operator bytes accessed'] == 0
    assert ca['operator calls'] == dict(k1=0, k3=0, k4=0, k5=0)


def _roi_inputs(seed=0, n=6, u=None, c=8):
    """A 4-level pyramid and boxes that reach every level."""
    g = torch.Generator().manual_seed(seed)
    u = u or n
    shapes = [(u, 32, 48, c), (u, 16, 24, c), (u, 8, 12, c), (u, 4, 6, c)]
    feats = [torch.randn(s, generator=g) for s in shapes]
    side = torch.tensor([20., 130., 260., 520., 60., 300.])[:n]
    xy = torch.rand(n, 3, 2, generator=g) * 120 - 10
    wh = side[:, None, None] * (0.9 + 0.2 * torch.rand(n, 3, 2, generator=g))
    rois = torch.cat([xy, xy + wh], -1)
    return feats, rois, shapes


@pytest.mark.parametrize('form', ['identity', 'frame_idx'])
def test_plain_backward_is_the_transpose(form):
    """roi_align_fpn_mm_bwd, the K3 operator's CPU kernel, against
    autograd of roi_align_fpn_mm, every level reached."""
    feats, rois, shapes = _roi_inputs(u=4 if form == 'frame_idx' else None)
    fidx = (torch.tensor([0, 1, 1, 2, 3, 3], dtype=torch.int32)
            if form == 'frame_idx' else None)
    leaves = [f.requires_grad_() for f in feats]
    out = roi_align_fpn_mm(leaves, rois, fidx)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    ref = torch.autograd.grad(out, leaves, g)
    got = roi_align_fpn_mm_bwd(g, rois, fidx, shapes)
    assert set(roi_levels(rois).flatten().tolist()) == {0, 1, 2, 3}
    for a, b in zip(got, ref):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_operator_counts_are_kernel_bounds():
    """K1 and K3 (RoIAlign's forward and backward through the model's
    wrapper), K4 and K5 (the fused head's and backbone's wrappers), each
    counted as tools/kernel_bounds.py counts its work on the inputs."""
    feats, rois, shapes = _roi_inputs()
    leaves = [f.clone().requires_grad_() for f in feats]

    def k1_k3():
        out = roi_align_cuda.roi_align_fpn(leaves, rois)
        out.sum().backward()
        return out

    ca = profiling.cost_analysis(k1_k3)
    sizes = [s[1:3] for s in shapes]
    b1, f1 = kernel_bounds.roi_work(rois.numpy(), None, sizes, (4, 8, 16, 32),
                                    8, 4)
    b3, f3 = kernel_bounds.roi_bwd_work(rois.numpy(), None, sizes,
                                        (4, 8, 16, 32), 8, 4, 6)
    assert ca['flops_by_operator']['mcgaze.roi_align_fpn'] == f1
    assert ca['flops_by_operator']['mcgaze.roi_align_fpn_bwd'] == f3
    assert ca['operator calls'] == dict(k1=1, k3=1, k4=0, k5=0)
    assert ca['operator bytes accessed'] == b1 + b3
    # the routed backward gives the plain gradient
    plain = [f.clone().requires_grad_() for f in feats]
    roi_align_fpn_mm(plain, rois).sum().backward()
    for a, b in zip(leaves, plain):
        assert float((a.grad - b.grad).abs().max()) <= \
            1e-5 * float(b.grad.abs().max())

    g = torch.Generator().manual_seed(2)
    c, t, q = 64, 7, 3
    query = torch.randn(2 * t, q, c, generator=g)
    w = [torch.randn(c, 3 * c, generator=g) * 0.05, torch.zeros(3 * c),
         torch.randn(c, c, generator=g) * 0.05, torch.zeros(c),
         torch.ones(c), torch.zeros(c)]
    ca = profiling.cost_analysis(
        lambda: stqi_attention.fused_stqi_attention(query, *w, t, heads=4))
    k4 = kernel_bounds.k4_bound(2, t, q, c)
    assert ca['flops'] == k4['flops']
    assert ca['operator bytes accessed'] == k4['bytes']

    from mcgaze_tpu_torch.models.resnet import ResNet
    layer = ResNet(26).layer1
    weights = [a for blk in layer
               for a in fused_bottleneck.fold_block_params(blk, torch.float32)]
    x = torch.randn(2, 8 * 8, 64, generator=g)
    ca = profiling.cost_analysis(
        lambda: fused_bottleneck.fused_bottleneck_chain(x, weights, 8, 8))
    k5 = kernel_bounds.k5_pixels_bound(
        2 * 64, dict(cin=64, mid=64, blocks=len(layer), down=True),
        'float32')
    assert ca['flops_by_operator']['mcgaze.fused_bottleneck_chain'] == \
        k5['flops']
    assert ca['operator bytes accessed'] == k5['bytes']
    assert ca['operator calls']['k5'] == 1


def test_cost_analysis_refuses_a_launch_outside_the_operators(monkeypatch):
    """A kernel's wrapper called bare (here the plain RoIAlign standing in
    for K1, counting a launch as the CUDA wrapper does) fails the count;
    the same call through the model's wrapper, through the operator, is
    counted."""
    plain = roi_align_cuda.roi_align_fpn_mm

    def counted(*args, **kwargs):
        roi_align_cuda.launch_count += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(roi_align_cuda, 'roi_align_fpn_mm', counted)
    feats, rois, _ = _roi_inputs()
    with pytest.raises(RuntimeError, match='launched 1 times'):
        profiling.cost_analysis(
            lambda: roi_align_cuda.roi_align_fpn_mm(feats, rois))
    ca = profiling.cost_analysis(
        lambda: roi_align_cuda.roi_align_fpn(feats, rois))
    assert ca['operator calls']['k1'] == 1


def _gaze_flops_written_out(model, imgs, whwh, monkeypatch):
    """The tiny gaze forward's flops as a sum: 2 x multiply-adds of every
    convolution and Linear module call (recorded by hooks on the calls'
    shapes), of the products that are not module calls (the attention's
    packed in_proj and the DynamicConv's fc_layer, in blocks of BLOCK_ROWS
    rows with the last one zero-padded; the attention's two products; the
    DynamicConv's two), and RoIAlign's work per kernel_bounds.roi_work."""
    from torch import nn

    from mcgaze_tpu_torch.models.heads import DynamicConv, _PackedAttention
    total = 0
    hooks = []

    def conv_hook(m, inp, out):
        nonlocal total
        kh, kw = m.kernel_size
        total += 2 * out.numel() * (m.in_channels // m.groups) * kh * kw

    def linear_hook(m, inp, out):
        nonlocal total
        total += 2 * (out.numel() // m.out_features) * m.in_features \
            * m.out_features

    def padded(rows):
        return -(-rows // BLOCK_ROWS) * BLOCK_ROWS

    def attn_hook(m, inp, out):
        nonlocal total
        b, s, e = inp[0].shape
        total += 2 * padded(b * s) * e * 3 * e      # in_proj, blocked
        total += 2 * 2 * b * s * s * e              # logits, values

    def dyn_hook(m, inp, out):
        nonlocal total
        mq, c, f = inp[0].shape[0], m.channels, m.feat_channels
        cells = inp[1].shape[1] * inp[1].shape[2]
        total += 2 * 2 * mq * cells * c * f         # two bmm
        total += 2 * padded(mq) * cells * c * c     # fc_layer, blocked

    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            hooks.append(mod.register_forward_hook(conv_hook))
        elif isinstance(mod, nn.Linear):
            hooks.append(mod.register_forward_hook(linear_hook))
        elif isinstance(mod, _PackedAttention):
            hooks.append(mod.register_forward_hook(attn_hook))
        elif isinstance(mod, DynamicConv):
            hooks.append(mod.register_forward_hook(dyn_hook))
    roi_calls = []
    plain = roi_align_cuda.roi_align_fpn_mm

    def recording(feats, rois, frame_idx, *args):
        roi_calls.append(([tuple(f.shape[1:3]) for f in feats],
                          rois.numpy().copy(), feats[0].shape[-1]))
        return plain(feats, rois, frame_idx, *args)

    monkeypatch.setattr(roi_align_cuda, 'roi_align_fpn_mm', recording)
    try:
        with torch.inference_mode():
            ca = profiling.cost_analysis(
                lambda: model(imgs, whwh, clip_length=7))
    finally:
        for h in hooks:
            h.remove()
    roi = sum(kernel_bounds.roi_work(r, None, sizes, (4, 8, 16, 32), c,
                                     4)[1] for sizes, r, c in roi_calls)
    assert len(roi_calls) == TINY_CFG.num_stages
    return ca, total + roi


def test_cost_analysis_counts_the_tiny_gaze_forward(monkeypatch, capsys):
    model = init_model(TINY_CFG, seed=0, device='cpu')
    g = torch.Generator().manual_seed(3)
    imgs = torch.randn(7, 64, 64, 3, generator=g)
    whwh = torch.full((7, 4), 64.0)
    ca, written = _gaze_flops_written_out(model, imgs, whwh, monkeypatch)
    assert ca['flops'] == written
    assert ca['operator calls'] == dict(k1=2, k3=0, k4=0, k5=0)

    # the JAX package's XLA figure for the same forward, for the record
    import jax
    import jax.numpy as jnp

    from mcgaze_tpu.models.mcgaze import ModelConfig as JCfg
    from mcgaze_tpu.models.mcgaze import init_model as jinit
    from mcgaze_tpu.utils.profiling import cost_analysis as jcost
    jcfg = JCfg(backbone_depth=26, num_stages=2, stage_loss_weights=(1., 1.),
                ffn_channels=256)
    jmodel, jvars = jinit(jcfg, jax.random.PRNGKey(0), image_size=(64, 64))

    def fwd(v, i, w):
        return jmodel.apply(v, i, w, clip_length=7)['stages'][-1]['boxes']

    xla = jcost(fwd, jvars, jnp.asarray(imgs.numpy()),
                jnp.asarray(whwh.numpy()))
    with capsys.disabled():
        print(f"\n[cost_analysis] tiny gaze forward (R26, 2 stages, FFN 256, "
              f"7 x 64x64): port {ca['flops']} flops; JAX/XLA "
              f"{xla.get('flops')} flops, {xla.get('bytes accessed')} bytes")


# ----------------------------------------------------------- config, logs

def _fields(text):
    """print_config's output -> {section.field: value text}."""
    out, section = {}, None
    for ln in text.splitlines()[1:]:
        m = re.match(r'^(\w+) = (\w+)\($', ln)
        if m:
            section = m.group(1)
            continue
        if ln == ')':
            section = None
            continue
        m = re.match(r'^\s+(\w+)=(.*),$', ln)
        if m and section:
            out[f'{section}.{m.group(1)}'] = m.group(2)
        elif ' = ' in ln:
            k, v = ln.split(' = ', 1)
            out[k] = v
    return out


# fields that only one package's configs have: none today
ONLY_PORT, ONLY_JAX = set(), set()


@pytest.mark.parametrize('name', sorted(SHIPPED))
def test_print_config_matches_jax(name, monkeypatch):
    """The gaze configs print the same value for every field; the query
    configs (InstBlink, TeViT) are not gaze configs and both tools refuse
    them alike."""
    argv = [SHIPPED[name], '--cfg-options', 'model.dtype=bfloat16']
    if name in ('instblink', 'tevit'):
        with pytest.raises(AttributeError) as port_err:
            run_main(print_config.main, argv)
        with pytest.raises(AttributeError) as jax_err:
            run_jax_main('misc/print_config.py', argv, monkeypatch)
        assert str(port_err.value) == str(jax_err.value)
        return
    _, ours = run_main(print_config.main, argv)
    ref = run_jax_main('misc/print_config.py', argv, monkeypatch)
    a, b = _fields(ours), _fields(ref)
    assert "dtype='bfloat16'" in ours and len(a) > 40
    assert set(a) - set(b) == ONLY_PORT and set(b) - set(a) == ONLY_JAX
    for k in set(a) & set(b):
        assert a[k] == b[k], k


def test_analyze_logs_matches_jax(tmp_path, monkeypatch):
    log = tmp_path / 'train_log.jsonl'
    rows = [dict(step=i, loss=1.0 / i, grad_norm=0.1 * i, time=0.5 + 0.01 * i,
                 data_time=0.05, sec_per_iter=0.55, lr=1e-3)
            for i in range(1, 9)]
    log.write_text('\n'.join(json.dumps(r) for r in rows))
    for argv in (['cal_train_time', str(log)],
                 ['plot_curve', str(log), '--keys', 'loss', 'grad_norm',
                  'absent']):
        _, ours = run_main(analyze_logs.main, argv)
        ref = run_jax_main('analysis_tools/analyze_logs.py', argv,
                           monkeypatch)
        assert ours == ref and ours
    assert 'avg iter time' in run_main(analyze_logs.main,
                                       ['cal_train_time', str(log)])[1]
    shutil.rmtree(tmp_path)


def _png_tree(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob('*.png'))}


def test_visualize_results_png_equal_to_jax(tmp_path, monkeypatch):
    from tests.test_data_and_driver import make_dataset
    ann, prefix = make_dataset(str(tmp_path / 'data'), num_videos=2,
                               length=6)
    with open(ann) as f:
        anno = json.load(f)
    rng = np.random.RandomState(4)
    results = []
    for video in anno['videos']:
        n = video['length']
        res = dict(video_id=video['id'], category_id=1,
                   fusion_gazes=(rng.randn(n, 3) * 0.5).tolist())
        for clue in ('face', 'eyes', 'head'):
            res[f'{clue}_bboxes'] = [None if f == 2 and clue == 'eyes'
                                     else (rng.rand(4) * 20 + 5).tolist()
                                     for f in range(n)]
            res[f'{clue}_gazes'] = [[0.3, 0.1, -0.95]] * n
            res[f'{clue}_score'] = rng.rand(n).tolist()
        results.append(res)
    rpath = tmp_path / 'results.json'
    rpath.write_text(json.dumps(results))
    outs = {}
    for who in ('port', 'jax'):
        argv = ['--results', str(rpath), '--anno', ann, '--root', prefix,
                '--out', str(tmp_path / who)]
        if who == 'port':
            run_main(visualize_results.main, argv)
        else:
            run_jax_main('analysis_tools/visualize_results.py', argv,
                         monkeypatch)
        outs[who] = _png_tree(tmp_path / who)
    assert len(outs['port']) == 12 and outs['port'] == outs['jax']
    shutil.rmtree(tmp_path)


def test_browse_dataset_png_equal_to_jax(tmp_path, monkeypatch):
    from tests.test_data_and_driver import make_dataset
    ann, prefix = make_dataset(str(tmp_path / 'data'))
    cfg = tmp_path / 'cfg.py'
    cfg.write_text(
        'from mcgaze_tpu.data.dataset import DataConfig\n'
        'from mcgaze_tpu.evaluation.driver import EvalConfig\n'
        'from mcgaze_tpu.models.mcgaze import ModelConfig\n'
        'from mcgaze_tpu.train.loop import OptimConfig\n'
        'model = ModelConfig()\n'
        f'data_train = DataConfig(ann_file={ann!r}, img_prefix={prefix!r},'
        ' scale=(32, 32), canvas=(32, 32), crop_size=0.68,'
        ' flip_ratio=0.5, batch_size=2)\n'
        'data_test = data_train\n')
    outs = {}
    for who in ('port', 'jax'):
        argv = [str(cfg), '--output-dir', str(tmp_path / who),
                '--num-clips', '3', '--seed', '5']
        if who == 'port':
            run_main(browse_dataset.main, argv)
        else:
            run_jax_main('misc/browse_dataset.py', argv, monkeypatch)
        outs[who] = _png_tree(tmp_path / who)
    assert len(outs['port']) == 21 and outs['port'] == outs['jax']
    shutil.rmtree(tmp_path)


# ------------------------------------------------------- tools on the CPU

def test_benchmark_synthetic_and_e2e(monkeypatch):
    """Synthetic mode, then --e2e on two fabricated videos as PNGs (cv2)
    and as .npy frames (the card's machine has no OpenCV), the fused
    configuration on the last; each prints its lines."""
    ret, out = run_main(benchmark.main, [
        GAZE360, '--synthetic', '--device', 'cpu', '--iters', '1',
        '--warmup', '1', '--batch', '2', '--cfg-options', *TINY_EVAL])
    assert re.search(r'Overall fps: [\d.]+ frames/s \([\d.]+ clips/s', out)
    assert ret['fps'] > 0
    e2e = [GAZE360, '--e2e', '--e2e-videos', '2', '--e2e-frames', '9',
           '--device', 'cpu', '--batch', '2', '--json', 'absent.json',
           '--cfg-options', *TINY_EVAL]
    ret, out = run_main(benchmark.main, e2e)
    assert re.search(r'E2E eval path \(pipelined\): [\d.]+ frames/s', out)
    assert 'E2E host phases' in out and ret['decoder'] in ('native', 'cv2')
    assert ret['frames'] == 18
    monkeypatch.setattr(npy_frames, 'have_cv2', lambda: False)
    ret, out = run_main(benchmark.main, e2e + [
        'model.backbone_impl=fused', 'model.fused_attention=True'])
    assert ret['decoder'] == npy_frames.NPY_DECODE and ret['frames'] == 18
    assert f'E2E decoder: {npy_frames.NPY_DECODE}' in out


def test_dedup_and_backbone_bench():
    rows, out = run_main(dedup_bench.main, [
        '--clips', '2', '--image', '32', '--iters', '1', '--warmup', '1',
        '--dtype', 'float32', '--device', 'cpu'])
    (line,) = json_lines(out)
    assert line == rows[0] and line['frames_unique'] == 11
    assert line['frames_plain'] == 14 and all_finite(line)
    assert line['speedup'] > 0
    rows, out = run_main(backbone_bench.main, [
        '--batch', '2', '--image', '32', '--iters', '1', '--warmup', '0',
        '--dtype', 'float32', '--device', 'cpu'])
    lines = json_lines(out)
    assert [r['variant'] for r in lines] == list(backbone_bench.VARIANTS)
    assert all(r['ms_per_step'] > 0 for r in lines)


@pytest.mark.parametrize('family', ['gaze', 'query'])
def test_step_breakdown(family):
    argv = ['--batch', '1', '--iters', '1', '--warmup', '0', '--dtype',
            'float32', '--device', 'cpu', '--family', family]
    argv += (['--height', '32', '--width', '64'] if family == 'query'
             else ['--image', '32'])
    ms, out = run_main(step_breakdown.main, argv)
    (line,) = json_lines(out)
    last = 'full_6stage' if family == 'query' else 'full_4stage'
    assert line == ms and all_finite(line) and line[last] > 0
    assert {'backbone', 'backbone_fpn', 'fpn', 'per_stage'} <= set(line)


@pytest.mark.parametrize('mode', ['eval', 'train', 'fused'])
def test_get_flops_prints(mode):
    argv = [GAZE360, '--device', 'cpu', '--cfg-options', *TINY_EVAL]
    if mode == 'train':
        argv.insert(1, '--train')
    if mode == 'fused':
        argv += ['model.backbone_impl=fused', 'model.fused_attention=True']
    ca, out = run_main(get_flops.main, argv)
    assert re.search(r'FLOPs:\s+[\d.]+ GFLOPs', out)
    assert 'Params:' in out and 'Kernel operator bytes' in out
    calls = dict(eval=dict(k1=2, k3=0, k4=0, k5=0),
                 train=dict(k1=2, k3=2, k4=0, k5=0),
                 fused=dict(k1=2, k3=0, k4=2, k5=1))[mode]
    assert ca['operator calls'] == calls


def test_train_bench_step_and_roofline(monkeypatch):
    rows, out = run_main(train_bench.main, [
        '--batch', '1', '--image', '32', '--iters', '1', '--warmup', '1',
        '--dtypes', 'float32', '--device', 'cpu'])
    (line,) = json_lines(out)
    assert line['mode'] == 'eager_step' and all_finite(line)
    monkeypatch.setattr(npy_frames, 'have_cv2', lambda: False)
    for family in ('gaze', 'query'):
        rows, out = run_main(train_bench.main, [
            '--e2e', '--roofline-only', '--family', family, '--videos', '2',
            '--frames', '12', '--batch', '2', '--image', '32',
            '--roofline-iters', '1', '--device', 'cpu'])
        (line,) = json_lines(out)
        assert line['mode'].startswith('host_roofline') and all_finite(line)
        assert line['decoder'] == npy_frames.NPY_DECODE


def test_serve_bench_engine(monkeypatch):
    """Engine mode on .npy request bodies (the stand-in the card's machine
    uses), two concurrency levels."""
    monkeypatch.setattr(npy_frames, 'have_cv2', lambda: False)
    out, text = run_main(serve_bench.main, [
        '--image', '32', '--dtype', 'float32', '--requests', '2',
        '--concurrency', '1', '2', '--device', 'cpu'])
    lines = json_lines(text)
    assert lines[-1] == out and out['decode'] == npy_frames.NPY_IMAGE_DECODE
    for row in out['results']:
        assert row['p99_ms'] >= row['p50_ms'] > 0 and all_finite(row)
        assert row['launches'] >= 1


def test_roi_kernel_check_cases_equal_jax_tool():
    """The port's make_case on its SHAPES returns the JAX tool's arrays bit
    for bit from the same RandomState(0) stream (the JAX tool imports JAX
    only in main)."""
    jtool = jax_tool('analysis_tools/roi_kernel_check.py')
    assert 'jax' not in jtool.__dict__
    ours, theirs = np.random.RandomState(0), np.random.RandomState(0)
    assert [s[0] for s in roi_kernel_check.SHAPES] == ['gaze', 'instblink']
    for _, n, r, sizes, c in roi_kernel_check.SHAPES:
        a = roi_kernel_check.make_case(ours, np, n, r, sizes, c)
        b = jtool.make_case(theirs, np, n, r, list(sizes), c)
        assert [x.shape for x in a[0]] == [(n, h, w, c) for h, w in sizes]
        for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        del a, b


def test_roi_kernel_check_runs_and_fails_a_breach(monkeypatch):
    """At small shapes on the CPU (the eager route is the plain version,
    the operator route the operators' CPU kernels, K3's the transpose
    written out): four cases a shape, every one inside --tol; a call 1%
    off (its forward, and so its gradient) is reported and exits 1."""
    monkeypatch.setattr(roi_kernel_check, 'SHAPES', (
        ('gaze', 2, 3, ((16, 16), (8, 8), (4, 4), (2, 2)), 8),
        ('instblink', 2, 10, ((24, 40), (12, 20), (6, 10), (3, 5)), 8)))
    ret, text = run_main(roi_kernel_check.main, ['--device', 'cpu'])
    lines = json_lines(text)
    assert ret == 0 and 'passed on cpu' in text
    assert [(x['shape'], x['case']) for x in lines] == [
        (s, f'{d}_{r}') for s in ('gaze', 'instblink')
        for r in ('eager', 'operator') for d in ('fwd', 'bwd')]
    assert all(x['ok'] and x['rel'] <= 1e-4 for x in lines)
    plain = roi_align_cuda.roi_align_fpn
    monkeypatch.setattr(roi_align_cuda, 'roi_align_fpn',
                        lambda *a, **k: plain(*a, **k) * 1.01)
    ret, text = run_main(roi_kernel_check.main, ['--device', 'cpu'])
    assert ret == 1 and 'FAILED: 8 case(s) over tol=0.0001' in text
    assert [round(x['rel'], 4) for x in json_lines(text)] == [0.01] * 8


@pytest.mark.parametrize('tool', [
    'benchmark', 'dedup_bench', 'backbone_bench', 'step_breakdown',
    'get_flops', 'train_bench', 'serve_bench', 'train', 'roi_kernel_check'])
def test_tools_refuse_cuda_without_card(tool):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    from mcgaze_tpu_torch.tools import train
    mains = dict(roi_kernel_check=(roi_kernel_check.main, []),
                 benchmark=(benchmark.main, [GAZE360, '--synthetic']),
                 dedup_bench=(dedup_bench.main, []),
                 backbone_bench=(backbone_bench.main, []),
                 step_breakdown=(step_breakdown.main, []),
                 get_flops=(get_flops.main, [GAZE360]),
                 train_bench=(train_bench.main, []),
                 serve_bench=(serve_bench.main, []),
                 train=(train.main, [GAZE360, '--synthetic']))
    main, argv = mains[tool]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv + ['--device', 'cuda'])


# --------------------------------------------- train CLI and the wrappers

def test_train_profile_dir_leaves_a_trace(tmp_path):
    from mcgaze_tpu_torch.tools import train
    prof = tmp_path / 'prof'
    ret, out = run_main(train.main, [
        GAZE360, '--synthetic', '--device', 'cpu', '--max-iters', '5',
        '--work-dir', str(tmp_path / 'w'), '--profile-dir', str(prof),
        '--cfg-options', *TINY, 'data_train.batch_size=1',
        'data_train.canvas=32,32'])
    assert f'profiler trace -> {prof}' in out
    assert 'env: torch: ' in out and 'env: cuda_kernels: ' in out
    (trace,) = prof.iterdir()
    events = json.loads(trace.read_text())['traceEvents']
    assert any('roi_align' in str(e.get('name', '')) or
               'einsum' in str(e.get('name', '')) for e in events)
    assert len(ret['history']) == 5
    shutil.rmtree(tmp_path)


WRAPPERS = ('train_gaze360', 'train_l2cs', 'test_gaze360', 'test_l2cs',
            'dist_train', 'dist_test')


@pytest.mark.parametrize('name', WRAPPERS)
def test_wrapper_scripts_parse_and_call_the_port(name):
    path = osp.join(ROOT, 'mcgaze_tpu_torch', 'tools', f'{name}.sh')
    assert os.access(path, os.X_OK)
    assert subprocess.run(['bash', '-n', path]).returncode == 0
    with open(path) as f:
        code = ''.join(ln for ln in f if not ln.lstrip().startswith('#'))
    # the port's modules, never the JAX package's scripts under tools/
    assert 'python -m mcgaze_tpu_torch.tools.' in code or \
        '-m mcgaze_tpu_torch.tools.' in code
    assert 'tools/' not in code
    if name.startswith('dist_'):
        assert 'torchrun --nproc-per-node' in code


@pytest.fixture(scope='module')
def wrapper_ws(tmp_path_factory):
    """A working directory laid out as the repo root: configs/, data/ with
    a fabricated Gaze360-form test set; removed at the end."""
    from tests.test_data_and_driver import make_dataset
    root = tmp_path_factory.mktemp('wrappers')
    os.symlink(CFG_DIR, root / 'configs')
    ann, prefix = make_dataset(str(root / 'fab'), num_videos=1, length=9)
    d = root / 'data' / 'gaze360'
    d.mkdir(parents=True)
    shutil.copy(ann, d / 'test.json')
    os.symlink(prefix, d / 'test_rawframes')
    yield root
    shutil.rmtree(root)


def _bash(script, args, cwd):
    path = osp.join(ROOT, 'mcgaze_tpu_torch', 'tools', script)
    out = subprocess.run(['bash', path, *args], cwd=cwd, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_train_and_test_wrappers_run(wrapper_ws):
    """train_gaze360.sh writes a checkpoint that test_gaze360.sh evaluates
    and scores."""
    tiny = ['--cfg-options', *TINY]
    out = _bash('train_gaze360.sh', [
        '--synthetic', '--device', 'cpu', '--max-iters', '1', '--work-dir',
        'w', *tiny, 'data_train.batch_size=1', 'data_train.canvas=32,32'],
        wrapper_ws)
    assert 'w/ckpt_1.pth' in out
    out = _bash('test_gaze360.sh', [
        'w/ckpt_1.pth', '--device', 'cpu', '--clip-batch', '2',
        '--cfg-options', *TINY_EVAL], wrapper_ws)
    assert 'fusion_gazes mean angular error 360: ' in out
    assert (wrapper_ws / 'results' /
            'results_multiclue_gaze_r50_gaze360_test.json').exists()
