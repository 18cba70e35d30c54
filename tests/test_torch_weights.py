"""The port's numpy copies of the vendored weights (xz_flagship, and
ag_r5f_v2 with its per-rollout latent), each with a golden replan of the JAX
package at those weights, for machines that have no JAX.

``visual_foresight_torch/weights/<name>/`` holds ``view0/params.npz`` (the
restored flax tree flattened with '/'-joined keys, f32, as
``TorchPredictor.restore`` reads it), a copy of the checkpoint's
``model_config.json``, and ``golden_replan_f32.npz``: one f32
``FusedCEMPlanner`` replan of the restored weights, normals injected, with
its inputs, scores, elites and the first two elites' predicted frames at the
last step of each action block (which keeps each file under 0.5 MB).  The
flagship's is 16 samples x 15 steps x 3 iterations; ag_r5f_v2's is 24
samples x 9 steps x 3 iterations with 13 elites over its 12 plan dims (a
refit of full rank, so that both frameworks factor it alike) and stores the
latents beside the plan noise.  Regenerate them where JAX and orbax are
installed::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_weights.py --write

The tests keep the files honest.  Each export equals the orbax restore bit
for bit.  Each golden equals a live JAX replan: scores rtol 1e-5, actions and
frames atol 1e-5 (the same XLA program on the CPU; the margin allows another
XLA version's summation order).  The port replays each golden on the CPU in
f32 with the same elites: scores rtol 1e-5, actions and frames atol 5e-5
(torch sums in another order through the full-width steps; measured 5.7e-7
relative on the flagship's scores and 4.7e-6 on its frames).
"""

import argparse
import json
import os
import shutil

import jax
import numpy as np
import pytest

from test_torch_planner import _jax_replan_draws
from test_torch_planner import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64
LIVE_RTOL, LIVE_ATOL = 1e-5, 1e-5
PORT_RTOL, PORT_ATOL = 1e-5, 5e-5


class Export:
    """One vendored checkpoint, its numpy export and its golden replan."""

    def __init__(self, name, adim, sdim, latent_dim, n_params, golden,
                 spec_hp):
        self.name, self.adim, self.sdim = name, adim, sdim
        self.latent_dim, self.n_params = latent_dim, n_params
        self.golden = golden
        self.spec_hp = dict(spec_hp, nactions=golden['nactions'],
                            repeat=golden['repeat'])
        self.ckpt_dir = os.path.join(REPO, 'benchmarks', 'models', name)
        self.export_dir = os.path.join(REPO, 'visual_foresight_torch',
                                       'weights', name)
        self.params_path = os.path.join(self.export_dir, 'view0',
                                        'params.npz')
        self.golden_path = os.path.join(self.export_dir,
                                        'golden_replan_f32.npz')
        # frames kept in the golden: the last step of each repeat block
        self.vis_steps = slice(golden['repeat'] - 1, None, golden['repeat'])


FLAGSHIP = Export(
    'xz_flagship', adim=3, sdim=3, latent_dim=0, n_params=4352719,
    golden=dict(num_samples=16, nactions=5, repeat=3, iterations=3,
                k_elite=5, n_vis=2, finalweight=10.0, seed=11),
    spec_hp={'initial_std': 0.05, 'initial_std_lift': 0.15,
             'initial_std_rot': np.pi / 18, 'initial_std_grasp': 2,
             'action_order': ['x', 'z', 'grasp']})
# ag_bench20's sampling widths (benchmarks/ag_bench20/hparams.py)
AG_R5F_V2 = Export(
    'ag_r5f_v2', adim=4, sdim=5, latent_dim=8, n_params=4364012,
    golden=dict(num_samples=24, nactions=3, repeat=3, iterations=3,
                k_elite=13, n_vis=2, finalweight=10.0, seed=12),
    spec_hp={'initial_std': 0.04, 'initial_std_lift': 0.6,
             'initial_std_rot': np.pi / 32, 'initial_std_grasp': 2,
             'action_order': None})
EXPORTS = (FLAGSHIP, AG_R5F_V2)


def _restore_jax(ex=FLAGSHIP):
    from visual_foresight_tpu.prediction.predictor import TPUPredictor
    jp = TPUPredictor(ex.ckpt_dir, {
        'designated_pixel_count': 1, 'img_dims': (H, W),
        'dtype': 'float32'}).restore()
    assert jp.restored, 'the vendored {} checkpoint did not restore'.format(
        ex.name)
    return jp


def flatten_params(tree):
    """Flax tree -> {'/'-joined key: numpy array}."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat['/'.join(str(p.key) for p in path)] = np.asarray(leaf)
    return flat


def golden_inputs(ex=FLAGSHIP):
    """The golden replan's seeded context, goal, distribution and normals
    (plan noise, and the latents of a stochastic model)."""
    from visual_foresight_tpu.planners import gaussian as jgauss
    g = ex.golden
    rng = np.random.RandomState(g['seed'])
    dim = g['nactions'] * ex.adim
    distribs = np.zeros((1, 2, H, W, 1), np.float32)
    distribs[:, :, 30, 20, 0] = 1.0
    spec = jgauss.make_action_spec(ex.spec_hp, ex.adim)
    noise, latents, _ = _jax_replan_draws(
        jax.random.PRNGKey(g['seed']), g['iterations'], g['num_samples'],
        dim, latent_dim=ex.latent_dim)
    inputs = {
        'images': rng.rand(1, 2, H, W, 3).astype(np.float32),
        'states': (rng.randn(2, ex.sdim) * 0.05).astype(np.float32),
        'distribs': distribs,
        'ctx_actions': (rng.randn(1, ex.adim) * 0.05).astype(np.float32),
        'goal': np.array([[[12.0, 44.0]]], np.float32),
        'mean0': np.zeros(dim, np.float32),
        'sigma0': np.asarray(jgauss.initial_sigma(spec), np.float32),
        'noise': noise.astype(np.float32),
    }
    if latents is not None:
        inputs['latents'] = latents.astype(np.float32)
    return inputs


def jax_golden_replan(jp, inputs, ex=FLAGSHIP):
    """The JAX package's f32 replan of the golden inputs."""
    from visual_foresight_tpu.planners import costs as jcosts
    from visual_foresight_tpu.planners import gaussian as jgauss
    from visual_foresight_tpu.planners.cem import FusedCEMPlanner
    g = ex.golden
    planner = FusedCEMPlanner(
        jp.model, jgauss.make_action_spec(ex.spec_hp, ex.adim),
        g['num_samples'], iterations=g['iterations'], k_elite=g['k_elite'],
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
        'vis_gen_images': np.asarray(
            out['vis']['gen_images'])[:, ex.vis_steps],
    }


def write_exports():
    """Write each export's ``params.npz``, ``model_config.json`` and golden
    replan."""
    for ex in EXPORTS:
        jp = _restore_jax(ex)
        os.makedirs(os.path.dirname(ex.params_path), exist_ok=True)
        flat = flatten_params(jp.params[0])
        np.savez(ex.params_path, **flat)
        shutil.copyfile(os.path.join(ex.ckpt_dir, 'model_config.json'),
                        os.path.join(ex.export_dir, 'model_config.json'))
        inputs = golden_inputs(ex)
        golden = dict(inputs, **jax_golden_replan(jp, inputs, ex))
        golden.update({k: np.asarray(v) for k, v in ex.golden.items()})
        np.savez_compressed(ex.golden_path, **golden)
        print('wrote {} ({} leaves, {} parameters) and {}'.format(
            ex.params_path, len(flat), sum(v.size for v in flat.values()),
            ex.golden_path))


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope='module')
def jax_flagship():
    return _restore_jax(FLAGSHIP)


@pytest.fixture(scope='module')
def golden():
    return _load(FLAGSHIP.golden_path)


def _check_export_bit_for_bit(ex, jp):
    want = flatten_params(jp.params[0])
    got = _load(ex.params_path)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32 == value.dtype, key
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert sum(v.size for v in got.values()) == ex.n_params
    with open(os.path.join(ex.export_dir, 'model_config.json')) as a, \
            open(os.path.join(ex.ckpt_dir, 'model_config.json')) as b:
        assert json.load(a) == json.load(b)
    return got


def _check_port_restores(ex):
    from visual_foresight_torch.prediction.predictor import TorchPredictor
    tp = TorchPredictor(ex.export_dir, {'dtype': 'float32'},
                        device='cpu').restore()
    assert tp.restored
    assert sum(p.numel() for p in tp.models[0].parameters()) == ex.n_params
    return tp


def _check_golden_is_live(ex, jp, golden):
    inputs = golden_inputs(ex)
    for key, value in inputs.items():
        np.testing.assert_array_equal(golden[key], value, err_msg=key)
    live = jax_golden_replan(jp, inputs, ex)
    np.testing.assert_allclose(golden['scores_per_itr'],
                               live['scores_per_itr'], rtol=LIVE_RTOL)
    np.testing.assert_array_equal(golden['elite_idx'], live['elite_idx'])
    np.testing.assert_array_equal(golden['vis_indices'], live['vis_indices'])
    np.testing.assert_allclose(golden['best_actions'], live['best_actions'],
                               atol=LIVE_ATOL)
    np.testing.assert_allclose(golden['vis_gen_images'],
                               live['vis_gen_images'], atol=LIVE_ATOL)


def _check_port_replays(ex, golden):
    import torch
    from visual_foresight_torch.planners import costs as tcosts
    from visual_foresight_torch.planners import gaussian as tgauss
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    tp = _check_port_restores(ex)
    g = {k: int(golden[k]) for k in ('num_samples', 'iterations', 'k_elite',
                                     'n_vis')}
    planner = FusedCEMPlanner(
        tgauss.make_action_spec(ex.spec_hp, ex.adim), g['num_samples'],
        iterations=g['iterations'], k_elite=g['k_elite'],
        finalweight=float(golden['finalweight']), n_vis=g['n_vis'],
        device='cpu')
    out = planner.replan(
        tp.models, golden['images'], golden['states'], golden['distribs'],
        golden['ctx_actions'], tcosts.distance_grid(golden['goal'], H, W),
        golden['mean0'], golden['sigma0'], noise=golden['noise'],
        latents=golden.get('latents'))
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
    np.testing.assert_allclose(
        out['vis']['gen_images'][:, ex.vis_steps].numpy(),
        golden['vis_gen_images'], atol=PORT_ATOL)
    assert torch.isfinite(out['vis']['gen_images']).all()


def test_export_equals_orbax_restore_bit_for_bit(jax_flagship):
    _check_export_bit_for_bit(FLAGSHIP, jax_flagship)


def test_port_restores_the_export():
    _check_port_restores(FLAGSHIP)


def test_golden_equals_live_jax_replan(jax_flagship, golden):
    _check_golden_is_live(FLAGSHIP, jax_flagship, golden)


def test_port_replays_golden_on_cpu(golden):
    _check_port_replays(FLAGSHIP, golden)


def test_goldens_stay_small():
    for ex in EXPORTS:
        assert os.path.getsize(ex.golden_path) < 512 * 1024, ex.name


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--write', action='store_true',
                    help='write the numpy exports and the golden replans')
    if ap.parse_args().write:
        jax.config.update('jax_platforms', 'cpu')
        write_exports()
