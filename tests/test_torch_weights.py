"""The port's numpy copy of the flagship weights, and a golden replan of the
JAX package at those weights, for machines that have no JAX.

``visual_foresight_torch/weights/xz_flagship/`` holds
``view0/params.npz`` (the restored flax tree flattened with '/'-joined keys,
f32, as ``TorchPredictor.restore`` reads it), a copy of the checkpoint's
``model_config.json``, and ``golden_replan_f32.npz``: one f32
``FusedCEMPlanner`` replan of the restored flagship (16 samples x 15 steps x
3 iterations, normals injected) with its inputs, scores, elites and the
first two elites' predicted frames at the last step of each action block
(5 of the 15 steps, which keeps the file under 0.5 MB).  Regenerate them
where JAX and orbax are installed::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_weights.py --write

The tests keep the files honest.  The export equals the orbax restore bit
for bit.  The golden equals a live JAX replan: scores rtol 1e-5, actions and
frames atol 1e-5 (the same XLA program on the CPU; the margin allows another
XLA version's summation order).  The port replays the golden on the CPU in
f32 with the same elites: scores rtol 1e-5, actions and frames atol 5e-5
(torch sums in another order through 46 full-width steps; measured 5.7e-7
relative on the scores and 4.7e-6 on the frames).
"""

import argparse
import json
import os
import shutil

import jax
import numpy as np
import pytest

from test_torch_planner import _jax_replan_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CKPT_DIR = os.path.join(REPO, 'benchmarks', 'models', 'xz_flagship')
EXPORT_DIR = os.path.join(REPO, 'visual_foresight_torch', 'weights',
                          'xz_flagship')
PARAMS_PATH = os.path.join(EXPORT_DIR, 'view0', 'params.npz')
GOLDEN_PATH = os.path.join(EXPORT_DIR, 'golden_replan_f32.npz')

H, W = 48, 64
GOLDEN = dict(num_samples=16, nactions=5, repeat=3, iterations=3, k_elite=5,
              n_vis=2, finalweight=10.0, seed=11)
SPEC_HP = {'initial_std': 0.05, 'initial_std_lift': 0.15,
           'initial_std_rot': np.pi / 18, 'initial_std_grasp': 2,
           'action_order': ['x', 'z', 'grasp'],
           'nactions': GOLDEN['nactions'], 'repeat': GOLDEN['repeat']}
# frames kept in the golden: the last step of each repeat block
VIS_STEPS = slice(GOLDEN['repeat'] - 1, None, GOLDEN['repeat'])
LIVE_RTOL, LIVE_ATOL = 1e-5, 1e-5
PORT_RTOL, PORT_ATOL = 1e-5, 5e-5


def _restore_jax():
    from visual_foresight_tpu.prediction.predictor import TPUPredictor
    jp = TPUPredictor(CKPT_DIR, {
        'designated_pixel_count': 1, 'img_dims': (H, W),
        'dtype': 'float32'}).restore()
    assert jp.restored, 'the vendored flagship checkpoint did not restore'
    return jp


def flatten_params(tree):
    """Flax tree -> {'/'-joined key: numpy array}."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat['/'.join(str(p.key) for p in path)] = np.asarray(leaf)
    return flat


def golden_inputs():
    """The golden replan's seeded context, goal, distribution and normals."""
    g = GOLDEN
    rng = np.random.RandomState(g['seed'])
    dim = g['nactions'] * 3
    distribs = np.zeros((1, 2, H, W, 1), np.float32)
    distribs[:, :, 30, 20, 0] = 1.0
    from visual_foresight_tpu.planners import gaussian as jgauss
    spec = jgauss.make_action_spec(SPEC_HP, 3)
    return {
        'images': rng.rand(1, 2, H, W, 3).astype(np.float32),
        'states': (rng.randn(2, 3) * 0.05).astype(np.float32),
        'distribs': distribs,
        'ctx_actions': (rng.randn(1, 3) * 0.05).astype(np.float32),
        'goal': np.array([[[12.0, 44.0]]], np.float32),
        'mean0': np.zeros(dim, np.float32),
        'sigma0': np.asarray(jgauss.initial_sigma(spec), np.float32),
        'noise': _jax_replan_noise(jax.random.PRNGKey(g['seed']),
                                   g['iterations'], g['num_samples'],
                                   dim).astype(np.float32),
    }


def jax_golden_replan(jp, inputs):
    """The JAX package's f32 replan of the golden inputs."""
    from visual_foresight_tpu.planners import costs as jcosts
    from visual_foresight_tpu.planners import gaussian as jgauss
    from visual_foresight_tpu.planners.cem import FusedCEMPlanner
    g = GOLDEN
    planner = FusedCEMPlanner(
        jp.model, jgauss.make_action_spec(SPEC_HP, 3), g['num_samples'],
        iterations=g['iterations'], k_elite=g['k_elite'],
        finalweight=g['finalweight'], n_vis=g['n_vis'])
    out = planner.replan(
        jp.params, jax.random.PRNGKey(g['seed']), inputs['images'],
        inputs['states'], inputs['distribs'], inputs['ctx_actions'],
        jcosts.distance_grid(inputs['goal'], H, W), inputs['mean0'],
        inputs['sigma0'])
    scores = np.asarray(out['scores_per_itr'])
    return {
        'scores_per_itr': scores,
        'elite_idx': np.argsort(scores, axis=1, kind='stable')[
            :, :g['k_elite']],
        'best_actions': np.asarray(out['best_actions']),
        'vis_indices': np.asarray(out['vis']['indices']),
        'vis_gen_images': np.asarray(out['vis']['gen_images'])[:, VIS_STEPS],
    }


def write_exports():
    """Write ``params.npz``, ``model_config.json`` and the golden replan."""
    jp = _restore_jax()
    os.makedirs(os.path.dirname(PARAMS_PATH), exist_ok=True)
    flat = flatten_params(jp.params[0])
    np.savez(PARAMS_PATH, **flat)
    shutil.copyfile(os.path.join(CKPT_DIR, 'model_config.json'),
                    os.path.join(EXPORT_DIR, 'model_config.json'))
    inputs = golden_inputs()
    golden = dict(inputs, **jax_golden_replan(jp, inputs))
    golden.update({k: np.asarray(v) for k, v in GOLDEN.items()})
    np.savez_compressed(GOLDEN_PATH, **golden)
    print('wrote {} ({} leaves, {} parameters) and {}'.format(
        PARAMS_PATH, len(flat), sum(v.size for v in flat.values()),
        GOLDEN_PATH))


@pytest.fixture(scope='module')
def jax_flagship():
    return _restore_jax()


@pytest.fixture(scope='module')
def golden():
    with np.load(GOLDEN_PATH) as f:
        return {k: f[k] for k in f.files}


def test_export_equals_orbax_restore_bit_for_bit(jax_flagship):
    want = flatten_params(jax_flagship.params[0])
    with np.load(PARAMS_PATH) as f:
        got = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32 == value.dtype, key
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert sum(v.size for v in got.values()) == 4352719
    with open(os.path.join(EXPORT_DIR, 'model_config.json')) as a, \
            open(os.path.join(CKPT_DIR, 'model_config.json')) as b:
        assert json.load(a) == json.load(b)


def test_port_restores_the_export():
    from visual_foresight_torch.prediction.predictor import TorchPredictor
    tp = TorchPredictor(EXPORT_DIR, {'dtype': 'float32'},
                        device='cpu').restore()
    assert tp.restored
    assert sum(p.numel() for p in tp.models[0].parameters()) == 4352719


def test_golden_equals_live_jax_replan(jax_flagship, golden):
    inputs = golden_inputs()
    for key, value in inputs.items():
        np.testing.assert_array_equal(golden[key], value, err_msg=key)
    live = jax_golden_replan(jax_flagship, inputs)
    np.testing.assert_allclose(golden['scores_per_itr'],
                               live['scores_per_itr'], rtol=LIVE_RTOL)
    np.testing.assert_array_equal(golden['elite_idx'], live['elite_idx'])
    np.testing.assert_array_equal(golden['vis_indices'], live['vis_indices'])
    np.testing.assert_allclose(golden['best_actions'], live['best_actions'],
                               atol=LIVE_ATOL)
    np.testing.assert_allclose(golden['vis_gen_images'],
                               live['vis_gen_images'], atol=LIVE_ATOL)


def test_port_replays_golden_on_cpu(golden):
    import torch
    from visual_foresight_torch.planners import costs as tcosts
    from visual_foresight_torch.planners import gaussian as tgauss
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.prediction.predictor import TorchPredictor
    tp = TorchPredictor(EXPORT_DIR, {'dtype': 'float32'},
                        device='cpu').restore()
    g = {k: int(golden[k]) for k in ('num_samples', 'iterations', 'k_elite',
                                     'n_vis')}
    planner = FusedCEMPlanner(
        tgauss.make_action_spec(SPEC_HP, 3), g['num_samples'],
        iterations=g['iterations'], k_elite=g['k_elite'],
        finalweight=float(golden['finalweight']), n_vis=g['n_vis'],
        device='cpu')
    out = planner.replan(
        tp.models, golden['images'], golden['states'], golden['distribs'],
        golden['ctx_actions'], tcosts.distance_grid(golden['goal'], H, W),
        golden['mean0'], golden['sigma0'], noise=golden['noise'])
    scores = out['scores_per_itr'].numpy()
    np.testing.assert_allclose(scores, golden['scores_per_itr'],
                               rtol=PORT_RTOL)
    np.testing.assert_array_equal(
        np.argsort(scores, axis=1, kind='stable')[:, :g['k_elite']],
        golden['elite_idx'])
    np.testing.assert_array_equal(out['vis']['indices'].numpy(),
                                  golden['vis_indices'])
    np.testing.assert_allclose(out['best_actions'].numpy(),
                               golden['best_actions'], atol=PORT_ATOL)
    np.testing.assert_allclose(out['vis']['gen_images'][:, VIS_STEPS].numpy(),
                               golden['vis_gen_images'], atol=PORT_ATOL)
    assert torch.isfinite(out['vis']['gen_images']).all()


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--write', action='store_true',
                    help='write the numpy export and the golden replan')
    if ap.parse_args().write:
        jax.config.update('jax_platforms', 'cpu')
        write_exports()
