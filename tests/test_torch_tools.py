"""Port parity: the data and profiling tools
(``training/visualize_predictions.py``, ``utils/check_dataset.py``,
``utils/profiling.py``) against the JAX package's.

- ``visualize_predictions.main`` on the same records and the same weights
  (saved once as JAX's orbax checkpoint through
  ``visual_foresight_tpu.prediction.checkpoints`` and once as the port's
  ``view0/params.npz``; the port's tool also from a TF1 bundle of them):
  the same PSNR report within 1e-3 dB, and strips within one grey level
  (f32, the classic backbone at 16x16, 4 trajectories of 5 frames).
- ``check_dataset``: ``tile_frames``, ``lift_success_rate`` and
  ``action_stats`` equal JAX's; ``main`` writes the same tiles.
- ``PhaseTimer``'s report has JAX's keys and counts; ``device_trace`` writes
  a chrome trace on the CPU holding the timer's phases.
"""

import glob
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.agent.utils.traj_saver import GeneralAgentSaver
from visual_foresight_torch.models.convert import flatten_flax
from visual_foresight_torch.prediction import tf1_import as t_tf1
from visual_foresight_torch.training import visualize_predictions as t_vis
from visual_foresight_torch.utils import check_dataset as t_check
from visual_foresight_torch.utils import profiling as t_prof
from visual_foresight_tpu.prediction import checkpoints
from visual_foresight_tpu.training import train_predictor as jtrain
from visual_foresight_tpu.training import visualize_predictions as j_vis
from visual_foresight_tpu.utils import check_dataset as j_check
from visual_foresight_tpu.utils import profiling as j_prof

H, W, T, N = 16, 16, 5, 4
PSNR_ATOL = 1e-3
FLAGS = ['--image_height', str(H), '--image_width', str(W),
         '--sequence_length', str(T), '--num_masks', '3',
         '--enc_features', '8', '16', '16', '--lstm_kernel', '3',
         '--n', str(N)]


@pytest.fixture(scope='module')
def records(tmp_path_factory):
    """Five trajectories of moving blobs (validation split), 6 frames."""
    root = str(tmp_path_factory.mktemp('records'))
    saver = GeneralAgentSaver(root, T + 1, traj_per_file=5,
                              split=(0.0, 0.0, 1.0))
    rr, cc = np.mgrid[:H, :W]
    for i in range(5):
        rng = np.random.RandomState(i)
        r, c = rng.uniform(3, H - 3, 2)
        dr, dc = rng.uniform(-1.5, 1.5, 2)
        color = rng.uniform(0.3, 1.0, 3)
        frames = [np.round(255 * (0.1 + 0.8 * np.exp(
            -((rr - r - t * dr) ** 2 + (cc - c - t * dc) ** 2) / 6.0)[
                ..., None] * color)).astype(np.uint8) for t in range(T + 1)]
        obs = {'images': np.stack(frames)[:, None],
               'state': rng.randn(T + 1, 3).astype(np.float32) * 0.1}
        policy_out = [{'actions': rng.uniform(-1, 1, 3).astype(np.float32)}
                      for _ in range(T + 1)]
        saver.save_traj({'traj_index': i}, obs, policy_out)
    saver.flush()
    return root


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    """One seeded weight set in the three forms the tools read."""
    root = tmp_path_factory.mktemp('weights')
    args = jtrain.build_argparser().parse_args(FLAGS[:-2])
    model = jtrain.build_model(args)
    params = model.init(jax.random.PRNGKey(3),
                        jnp.zeros((1, 2, H, W, 3)),
                        jnp.zeros((1, T - 1, 3)), jnp.zeros((1, 2, 3)))
    rng = np.random.RandomState(4)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.randn(*x.shape).astype(np.float32)
        * 0.05, params)
    checkpoints.save_params(params, str(root / 'jax' / 'view0'), 1)
    os.makedirs(str(root / 'port' / 'view0'))
    np.savez(str(root / 'port' / 'view0' / 'params.npz'),
             **flatten_flax(params))
    t_tf1.export_tf1_checkpoint(params, str(root / 'tf1' / 'view0' /
                                             'model-20'))
    return root


def _strips(out_dir):
    return [cv2.imread(os.path.join(out_dir, 'traj{}.png'.format(b)))
            for b in range(N)]


@pytest.mark.parametrize('source', ['params_npz', 'tf1_bundle'])
def test_visualize_predictions_matches_jax(records, weights, tmp_path,
                                           source):
    jax_out, port_out = str(tmp_path / 'jax'), str(tmp_path / 'port')
    want = j_vis.main(FLAGS + ['--data_dir', records, '--model_dir',
                               str(weights / 'jax'), '--out_dir', jax_out])
    model_dir = weights / ('port' if source == 'params_npz' else 'tf1')
    got = t_vis.main(FLAGS + ['--data_dir', records, '--model_dir',
                              str(model_dir), '--out_dir', port_out,
                              '--device', 'cpu'])
    assert sorted(got) == sorted(want)
    assert len(got['psnr_per_step']) == T - 1
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=PSNR_ATOL,
                                   err_msg=key)
    assert np.isfinite(got['psnr_autoregressive'])
    for g, w in zip(_strips(port_out), _strips(jax_out)):
        assert g.shape == w.shape == (2 * H, (T - 1) * W, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_visualize_predictions_needs_weights(records, tmp_path):
    with pytest.raises(FileNotFoundError, match='params.npz'):
        t_vis.main(FLAGS + ['--data_dir', records, '--model_dir',
                            str(tmp_path), '--device', 'cpu'])


def test_check_dataset_helpers_equal_jax():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (10, 4, 2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_array_equal(t_check.tile_frames(images),
                                  j_check.tile_frames(images))
    assert t_check.tile_frames(images).shape == (8 * 8, 4 * 8, 3)
    states = rng.randn(6, 5, 3) * 0.05
    states[..., -1] = rng.rand(6, 5) * 2 - 0.5
    for kw in ({}, {'z_dim': 0, 'z_thresh': -0.01}):
        assert t_check.lift_success_rate(states, **kw) == \
            j_check.lift_success_rate(states, **kw)
    actions = rng.randn(6, 5, 4)
    assert t_check.action_stats(actions) == j_check.action_stats(actions)


def test_check_dataset_main_equals_jax(records, tmp_path, capsys):
    outs = {}
    for side, module in (('jax', j_check), ('port', t_check)):
        outs[side] = str(tmp_path / '{}.png'.format(side))
        module.main([records, '--batch_size', '3', '--mode', 'val',
                     '--out', outs[side]])
    printed = capsys.readouterr().out
    assert printed.count('lift success rate') == 2
    tiles = [cv2.imread(outs[s]) for s in ('jax', 'port')]
    assert tiles[0].shape == (3 * H, (T + 1) * W, 3)
    np.testing.assert_array_equal(tiles[1], tiles[0])


def _timed(module):
    timer = module.PhaseTimer()
    for name, n in (('sample', 3), ('predict', 2), ('score', 1)):
        for _ in range(n):
            with timer.phase(name):
                torch.ones(8).sum()
    return timer


def test_phase_timer_report_equals_jax(capsys):
    got, want = _timed(t_prof).report(), _timed(j_prof).report()
    assert sorted(got) == sorted(want) == ['predict', 'sample', 'score']
    for name in want:
        assert sorted(got[name]) == sorted(want[name]) == \
            ['count', 'mean_ms', 'total_s']
        assert got[name]['count'] == want[name]['count']
    _timed(t_prof).log()
    assert json.loads(capsys.readouterr().out)['sample']['count'] == 3


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with t_prof.device_trace(str(tmp_path)) as prof:
        timer = _timed(t_prof)
    assert timer.report()['predict']['count'] == 2
    files = glob.glob(str(tmp_path / '*.pt.trace.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert {'sample', 'predict', 'score'} <= names
    assert any(e.name == 'predict' for e in prof.events())


def test_visualize_predictions_needs_a_card_unless_told_cpu(records,
                                                            weights):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    argv = FLAGS + ['--data_dir', records, '--model_dir',
                    str(weights / 'port')]
    with pytest.raises(RuntimeError, match='no CUDA device'):
        t_vis.main(argv)
