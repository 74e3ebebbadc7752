"""The port's YOLOv5 head detector against the JAX package's.

One seeded yolov5-named state dict (`model.{i}.*`, the CrowdHuman
checkpoint's names) loads into the port with `load_yolo_weights` and into
the JAX package through `convert_torch_yolo`. ConvBlock, Focus, C3 and SPP
agree at 1e-5; the whole YoloV5 at a narrow size (width 0.25, depth 0.33,
128 px) gives level maps within 1e-4; decode_predictions agrees at 1e-5;
nms_static and postprocess give exactly the JAX keep-sets on seeded boxes
with overlaps, exact score ties and near-ties; HeadDetector on three
frames, one of which needs a resize, gives the same boxes within 1e-3 px.
The NMS's device work does not grow with the candidate count k.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mcgaze_tpu_torch.models import yolov5 as py
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401

CFG = py.YoloConfig(depth_multiple=0.33, width_multiple=0.25, img_size=128)
BN_LEAVES = {'bn.weight': ('params', 'scale'), 'bn.bias': ('params', 'bias'),
             'bn.running_mean': ('batch_stats', 'mean'),
             'bn.running_var': ('batch_stats', 'var')}


def seeded_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """Random values for every entry of module's state dict: convolutions
    at 1/sqrt(fan_in), BN scales and variances in [0.5, 1.5), shifts and
    means ~0.1; the Detect convs' biases ~N(0, 1), so scores spread."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith('num_batches_tracked'):
            a = np.zeros((), np.int64)
        elif k.endswith('weight') and len(shape) == 4:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith(('bn.weight', 'running_var')):
            a = rng.rand(*shape) + 0.5
        elif k.startswith('model.24.'):
            a = rng.randn(*shape)
        else:
            a = rng.randn(*shape) * 0.1
        sd[k] = torch.from_numpy(np.asarray(a, v.numpy().dtype))
    return sd


def flax_block_vars(sd: dict) -> dict:
    """A block's state dict (relative names) -> its flax variables:
    C3's `m.{j}` is `m{j}`, conv kernels OIHW -> HWIO."""
    out = {'params': {}, 'batch_stats': {}}
    for k, v in sd.items():
        if k.endswith('num_batches_tracked'):
            continue
        parts = k.split('.')
        path = []
        i = 0
        while i < len(parts) - 2:
            if parts[i] == 'm' and parts[i + 1].isdigit():
                path.append('m' + parts[i + 1])
                i += 2
            else:
                path.append(parts[i])
                i += 1
        leaf = '.'.join(parts[-2:])
        if leaf == 'conv.weight':
            coll, name = 'params', 'kernel'
            path.append('conv')
            arr = v.numpy().transpose(2, 3, 1, 0)
        else:
            coll, name = BN_LEAVES[leaf]
            path.append('bn')
            arr = v.numpy()
        node = out[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = arr
    return out


def nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2))


BLOCKS = {
    'convblock': (lambda: py.ConvBlock(8, 16, 3, 2),
                  lambda jy: jy.ConvBlock(16, 3, 2), 8),
    'focus': (lambda: py.Focus(3, 16), lambda jy: jy.Focus(16), 3),
    'c3': (lambda: py.C3(16, 32, 2), lambda jy: jy.C3(32, 2), 16),
    'c3_no_shortcut': (lambda: py.C3(16, 32, 1, False),
                       lambda jy: jy.C3(32, 1, False), 16),
    'spp': (lambda: py.SPP(32, 24), lambda jy: jy.SPP(24), 32),
}


@pytest.mark.parametrize('name', list(BLOCKS))
def test_block_matches_jax(name):
    import mcgaze_tpu.models.yolov5 as jy
    make, make_jax, cin = BLOCKS[name]
    block = make().eval()
    sd = seeded_state_dict(block, seed=len(name))
    block.load_state_dict(sd)
    x = np.random.RandomState(1).randn(2, 16, 12, cin).astype(np.float32)
    with torch.no_grad():
        ours = block(nchw(x)).numpy().transpose(0, 2, 3, 1)
    ref = np.asarray(make_jax(jy).apply(flax_block_vars(sd), jnp.asarray(x)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.fixture(scope='module')
def yolo():
    """(port model, JAX variables, the state dict) of one seeded dict."""
    from mcgaze_tpu.models.yolov5 import convert_torch_yolo
    model = py.YoloV5(CFG).eval()
    sd = seeded_state_dict(model, seed=3)
    # yolov5's Detect buffers ride along in a CrowdHuman state dict
    strides = torch.tensor(py.STRIDES, dtype=torch.float32).view(-1, 1, 1)
    anchors = torch.tensor(CFG.anchors, dtype=torch.float32)
    sd['model.24.anchors'] = anchors / strides
    sd['model.24.anchor_grid'] = anchors.view(3, 1, 3, 1, 1, 2)
    py.load_yolo_weights(model, sd)
    return model, convert_torch_yolo(sd, jax_cfg()), sd


def jax_cfg():
    """CFG as the JAX package's YoloConfig."""
    from mcgaze_tpu.models.yolov5 import YoloConfig
    return YoloConfig(**{f: getattr(CFG, f) for f in (
        'num_classes', 'depth_multiple', 'width_multiple', 'anchors',
        'img_size', 'dtype')})


def test_yolov5_level_maps_match_jax(yolo):
    model, variables, _ = yolo
    x = np.random.RandomState(2).rand(2, 128, 128, 3).astype(np.float32)
    with torch.no_grad():
        ours = [m.numpy() for m in model(torch.from_numpy(x))]
    from mcgaze_tpu.models.yolov5 import YoloV5
    ref = [np.asarray(m) for m in YoloV5(jax_cfg()).apply(variables,
                                                          jnp.asarray(x))]
    assert [m.shape for m in ours] == [m.shape for m in ref] == [
        (2, 16, 16, 21), (2, 8, 8, 21), (2, 4, 4, 21)]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_load_yolo_weights_checks_anchors(yolo):
    _, _, sd = yolo
    bad = dict(sd, **{'model.24.anchor_grid': sd['model.24.anchor_grid']
                      * 2})
    with pytest.raises(ValueError, match='anchors'):
        py.load_yolo_weights(py.YoloV5(CFG), bad)
    nested = {'model.' + k: v for k, v in sd.items()}
    model = py.load_yolo_weights(py.YoloV5(CFG), nested)
    assert torch.equal(model.model[0].conv.conv.weight,
                       sd['model.0.conv.conv.weight'])


def test_decode_matches_jax():
    from mcgaze_tpu.models.yolov5 import decode_predictions as jdecode
    rng = np.random.RandomState(4)
    maps = [rng.randn(2, s, s, 21).astype(np.float32) * 3
            for s in (16, 8, 4)]
    ours = py.decode_predictions(CFG, [torch.from_numpy(m)
                                       for m in maps]).numpy()
    ref = np.asarray(jdecode(jax_cfg(), [jnp.asarray(m) for m in maps]))
    assert ours.shape == ref.shape == (2, 3 * (256 + 64 + 16), 7)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def clustered_boxes(rng, n_clusters=12, per=10):
    """Boxes in overlapping clusters; scores with exact ties and ties
    1e-7 apart."""
    centers = rng.uniform(20, 300, (n_clusters, 2))
    ctr = np.repeat(centers, per, 0) + rng.randn(n_clusters * per, 2) * 6
    wh = rng.uniform(20, 60, (n_clusters * per, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
    scores = np.round(rng.uniform(0, 1, n_clusters * per), 2)
    scores[::7] = scores[3]                       # exact ties
    scores[1::11] = scores[5] + 1e-7              # near-ties
    scores[rng.rand(len(scores)) < 0.2] = 0.0     # below conf
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize('max_det', [300, 40])
def test_nms_keep_sets_match_jax(max_det):
    from mcgaze_tpu.models.yolov5 import nms_static as jnms
    boxes, scores = clustered_boxes(np.random.RandomState(5))
    ob, os_, oi = py.nms_static(torch.from_numpy(boxes),
                                torch.from_numpy(scores), 0.45, max_det)
    rb, rs, ri = (np.asarray(v) for v in jnms(jnp.asarray(boxes),
                                              jnp.asarray(scores), 0.45,
                                              max_det))
    np.testing.assert_array_equal(oi.numpy(), ri)
    np.testing.assert_array_equal(os_.numpy() > 0, rs > 0)
    np.testing.assert_array_equal(os_.numpy(), rs)
    np.testing.assert_array_equal(ob.numpy(), rb)
    kept = int((rs > 0).sum())
    assert 5 < kept < int((scores > 0).sum()), kept   # suppression happened


def test_postprocess_matches_jax():
    from mcgaze_tpu.models.yolov5 import postprocess as jpost
    rng = np.random.RandomState(6)
    boxes, scores = clustered_boxes(rng)
    n = len(boxes)
    xy = (boxes[:, :2] + boxes[:, 2:]) / 2
    wh = boxes[:, 2:] - boxes[:, :2]
    obj = np.sqrt(np.maximum(scores, 1e-3))
    cls = rng.rand(n, 2).astype(np.float32)
    cls[np.arange(n), rng.randint(0, 2, n)] = obj    # two classes
    preds = np.concatenate([xy, wh, obj[:, None], cls], 1).astype(np.float32)
    ob, os_, oc = py.postprocess(CFG, torch.from_numpy(preds)[None], 0.25,
                                 0.45, 100)
    rb, rs, rc = (np.asarray(v) for v in jpost(jax_cfg(), jnp.asarray(preds),
                                               0.25, 0.45, 100))
    np.testing.assert_array_equal(os_[0] > 0, rs > 0)
    np.testing.assert_array_equal(os_[0], rs)
    np.testing.assert_array_equal(oc[0], rc)
    np.testing.assert_array_equal(ob[0], rb)
    assert len(set(rc[rs > 0].tolist())) == 2


def test_nms_device_work_does_not_grow_with_k():
    """The ATen ops postprocess dispatches (each one launch or none on the
    card: views launch nothing) are the same for 20 and 300 candidates,
    and for 1 and 8 images: 65 with torch 2.13."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    rng = np.random.RandomState(7)
    counts = {}
    for b, a in ((1, 20), (1, 300), (8, 300)):
        preds = torch.from_numpy(rng.rand(b, a, 7).astype(np.float32) * 100)
        with Count() as c:
            py.postprocess(CFG, preds, 0.25, 0.45, 300)
        counts[(b, a)] = c.ops
    assert counts[(1, 20)] == counts[(1, 300)] == counts[(8, 300)]
    assert len(counts[(1, 300)]) < 80


def test_head_detector_matches_jax(yolo):
    from mcgaze_tpu.models.yolov5 import HeadDetector as JHeadDetector
    model, variables, _ = yolo
    rng = np.random.RandomState(8)
    # 96x128 fits the 128 canvas as it is; 150x200 needs a resize
    frames = [rng.randint(0, 255, (96, 128, 3), np.uint8),
              rng.randint(0, 255, (128, 128, 3), np.uint8),
              rng.randint(0, 255, (150, 200, 3), np.uint8)]
    ours = py.HeadDetector(model, conf_thres=0.3)(frames)
    ref = JHeadDetector(variables, jax_cfg(), conf_thres=0.3)(frames)
    assert sum(len(d) for d in ref) > 3
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=1e-5)


def test_letterbox_resizes_only_when_needed():
    img = np.random.RandomState(9).randint(0, 255, (480, 640, 3), np.uint8)
    canvas, r, (dx, dy) = py.letterbox(img, 640)
    assert (r, dx, dy) == (1.0, 0, 80)
    np.testing.assert_array_equal(canvas[80:560], img)
    assert (canvas[:80] == 114).all() and (canvas[560:] == 114).all()
