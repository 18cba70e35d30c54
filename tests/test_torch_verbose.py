"""Port parity: the verbose plan dumps, ``visual_foresight_torch``'s against
the JAX package's, and the port's GIF writer and viridis table.

- ``PixelCostController._dump_verbose`` of both packages on the same
  ``result`` (two cameras, two designated pixels, three elites; the port's
  given torch tensors, JAX's numpy arrays) puts the same items on the file
  worker: the same paths, the same start frames, the same GIF frames (the
  distributions through the port's viridis table against matplotlib's) and
  the same ``plan.html`` text.  ``construct_html`` renders the same text.
- The viridis table equals ``matplotlib.cm.viridis`` (the promised bound
  is 1/255; they are equal), and the lookup colours as the JAX dump does.
- The GIF writer's files, decoded with ``imageio`` (here, in the test
  only), hold the input frames: exactly where the frames have at most 256
  colours, within the 3-3-2 quantiser's error (18, 18, 42) otherwise; the
  LZW table is cleared when it fills.
- ``PixelCostController``, ``GoalImController`` and
  ``ClassifierController`` plan on the CPU with a real file worker as
  ``verbose_worker`` and write ``plan.html`` and well-formed GIFs; a torch
  tensor put on the worker's queue is refused."""

import io
import os
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_controllers import AG_PARAMS, BASE_POLICY
from test_torch_controller import PREDICTOR
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.agent.utils.file_saver import start_file_worker
from visual_foresight_torch.policy.cem_controllers import (
    GoalImController, PixelCostController)
from visual_foresight_torch.policy.cem_controllers.variants import (
    ClassifierController)
from visual_foresight_torch.policy.cem_controllers.visualizer import (
    construct_html as t_html)
from visual_foresight_torch.policy.cem_controllers.visualizer.colormap import (
    VIRIDIS, viridis)
from visual_foresight_torch.utils.gif import QUANT_ERROR, encode_gif
from visual_foresight_tpu.policy.cem_controllers import (
    pixel_cost_controller as j_pixel)
from visual_foresight_tpu.policy.cem_controllers.visualizer import (
    construct_html as j_html)


class ListWorker:
    """Collects what a dump puts on the file worker's queue."""

    def __init__(self):
        self.items = []

    def put(self, item):
        self.items.append(item)


def _decode(data):
    iio = pytest.importorskip('imageio.v3')
    frames = np.asarray(iio.imread(io.BytesIO(data), index=None,
                                   extension='.gif', mode='RGB'))
    return frames if frames.ndim == 4 else frames[None]


def _dump_items(dump, vis, as_tensor):
    rng = np.random.RandomState(3)
    ncam, n_desig, h, w = 2, 2, 12, 16
    stub = SimpleNamespace(
        _verbose_worker=ListWorker(), _t=7, _n_iter=3, _n_cam=ncam,
        _n_desig=n_desig, _img_height=h, _img_width=w,
        _hp=SimpleNamespace(verbose_img_height=96),
        _images=(rng.rand(2, ncam, h, w, 3) * 255).astype(np.uint8),
        # one pixel off the image: the dump clips it
        _desig_pix=np.array([[[3, 4], [11, 15]], [[0, 0], [20, 2]]]),
        _goal_pix=np.array([[[5, 9], [1, 1]], [[6, 6], [-1, 30]]]))
    conv = (lambda x: torch.as_tensor(x)) if as_tensor else np.asarray
    dump(stub, {'vis': {k: conv(v) for k, v in vis.items()}})
    return stub._verbose_worker.items


def test_pixel_cost_dump_equals_jax():
    rng = np.random.RandomState(4)
    nv, steps, ncam, h, w, p = 3, 5, 2, 12, 16, 2
    distribs = rng.rand(nv, steps, ncam, h, w, p).astype(np.float32) ** 4
    distribs[0, 0, 0, :, :, 0] = 0.0             # an all-zero frame
    vis = {'gen_images': rng.rand(nv, steps, ncam, h, w, 3).astype(
               np.float32),
           'gen_distribs': distribs,
           'scores': np.array([0.125, 0.5, 1.0 / 3], np.float32)}
    port = _dump_items(PixelCostController._dump_verbose, vis, True)
    ref = _dump_items(j_pixel.PixelCostController._dump_verbose, vis, False)
    assert [i[:2] for i in port] == [i[:2] for i in ref]
    assert [i[0] for i in port].count('mov') == ncam * (p + 1) * nv
    for a, b in zip(port, ref):
        if a[0] == 'txt_file':
            assert a[2] == b[2]
            assert a[1] == 'planning_7_itr_2/plan.html'
        elif a[0] == 'img':
            assert np.array_equal(a[2], b[2])
        else:
            assert a[3] == b[3] and len(a[2]) == len(b[2]) == steps
            for fa, fb in zip(a[2], b[2]):
                assert fa.dtype == np.uint8 and np.array_equal(fa, fb)


def test_fill_template_equals_jax():
    content = OrderedDict([('start', ['a.png', 'a.png']),
                           ('pred', ['p_0.gif', 'p_1.gif']),
                           ('scores', np.array([0.25, 2.0], np.float32)),
                           ('count', 3)])
    assert t_html.fill_template(2, 11, content, img_height=64) == \
        j_html.fill_template(2, 11, content, img_height=64)


def test_viridis_table_is_matplotlibs():
    cm = pytest.importorskip('matplotlib.cm')
    want = cm.viridis(np.linspace(0, 1, 256))[:, :3]
    assert np.abs(VIRIDIS - want).max() <= 1.0 / 255
    assert np.array_equal(VIRIDIS, want)
    x = np.concatenate([np.random.RandomState(0).rand(5000),
                        [0.0, 1.0, -0.5, 2.0, np.nan, 255 / 256,
                         np.nextafter(1.0, 0)]]).astype(np.float32)
    # as the JAX dump colours a frame
    assert np.array_equal(viridis(x),
                          (cm.viridis(x)[..., :3] * 255).astype(np.uint8))


@pytest.mark.parametrize('shape,colours', [
    ((4, 12, 16), 5), ((3, 48, 64), 256), ((1, 1, 1), 1), ((2, 7, 300), 2),
    ((45, 48, 64), 200)])
def test_gif_is_lossless_within_256_colours(shape, colours):
    rng = np.random.RandomState(colours)
    palette = rng.randint(0, 256, (colours, 3)).astype(np.uint8)
    frames = palette[rng.randint(0, colours, shape)]
    data = encode_gif(frames, fps=4)
    assert data[:6] == b'GIF89a' and data[-1:] == b';'
    assert np.array_equal(_decode(data), frames)


@pytest.mark.parametrize('shape', [(3, 48, 64), (1, 128, 128),
                                   (2, 200, 150)])
def test_gif_quantises_within_its_bound(shape):
    frames = np.random.RandomState(1).randint(
        0, 256, shape + (3,)).astype(np.uint8)
    got = _decode(encode_gif(frames))
    assert got.shape == frames.shape
    err = np.abs(got.astype(int) - frames).max(axis=(0, 1, 2))
    assert (err <= QUANT_ERROR).all(), err
    assert (err >= np.array(QUANT_ERROR) - 1).all()   # the bound is tight


def test_gif_frame_delay_follows_fps():
    pil = pytest.importorskip('PIL.Image')
    frames = np.zeros((3, 4, 4, 3), np.uint8)
    frames[1] = 255
    img = pil.open(io.BytesIO(encode_gif(frames, fps=5)))
    assert img.n_frames == 3
    assert img.info['duration'] == 200 and img.info['loop'] == 0


def _controller_case(kind):
    if kind == 'pixel':
        return PixelCostController, {'desig_pix': np.array([[[8, 12]]]),
                                     'goal_pix': np.array([[[3, 20]]])}
    goal = np.random.RandomState(6).rand(1, 1, 16, 24, 3).astype(np.float32)
    if kind == 'goal_image':
        return GoalImController, {'goal_image': goal}
    return ClassifierController, {'goal_image': goal}


@pytest.mark.parametrize('kind', ['pixel', 'goal_image', 'classifier'])
def test_controller_plans_under_a_file_worker(kind, tmp_path):
    cls, act_kw = _controller_case(kind)
    policy = dict(BASE_POLICY, predictor_hparams=PREDICTOR, device='cpu')
    policy.pop('verbose')              # True, the default: dumps on
    if kind == 'classifier':
        policy['classifier_path'] = str(tmp_path / 'no_classifier')
    with pytest.warns(UserWarning, match='seeded'):
        ctrl = cls(AG_PARAMS, policy)
    worker = start_file_worker()
    try:
        with pytest.raises(TypeError, match='numpy'):
            worker.put(('img', 'x.png', torch.zeros(2, 2, 3)))
        worker.put(('path', str(tmp_path)))
        rng = np.random.RandomState(2)
        frames = (rng.rand(3, 1, 16, 24, 3) * 255).astype(np.uint8)
        states = (rng.randn(3, 3) * 0.05).astype(np.float32)
        ctrl.reset()
        for t in range(3):
            out = ctrl.act(t=t, i_tr=0, images=frames[:t + 1],
                           state=states[:t + 1], verbose_worker=worker,
                           **act_kw)
            assert np.isfinite(out['actions']).all()
    finally:
        worker.close()
    folder = tmp_path / 'planning_1_itr_2'
    html = (folder / 'plan.html').read_text()
    assert 'planning step t=1 CEM iteration 2' in html
    gifs = sorted(f for f in os.listdir(str(folder)) if f.endswith('.gif'))
    # one GIF a visualised elite (3: the elite count) of each row: the
    # distribution and the frames, or the frames alone
    assert len(gifs) == {'pixel': 6, 'goal_image': 3, 'classifier': 3}[kind]
    assert (tmp_path / 'planning_2_itr_2' / 'plan.html').is_file()
    for name in gifs:
        assert name in html
        data = (folder / name).read_bytes()
        assert data[:6] == b'GIF89a'
        assert _decode(data).shape == (6, 16, 24, 3)


def test_score_histogram_equals_jax():
    pytest.importorskip('matplotlib')
    from visual_foresight_torch.policy.cem_controllers.visualizer import (
        plot_helper as t_plot)
    from visual_foresight_tpu.policy.cem_controllers.visualizer import (
        plot_helper as j_plot)
    scores = np.random.RandomState(0).rand(64)
    got = t_plot.plot_score_hist(scores, tick_value=0.4)
    assert got.dtype == np.uint8 and got.std() > 0
    assert np.array_equal(got, j_plot.plot_score_hist(scores, tick_value=0.4))
