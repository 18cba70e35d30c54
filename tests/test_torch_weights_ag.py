"""The numpy export of ag_r5f_v2 (latent_dim 8, adim 4, sdim 5), its golden
Gaussian replan and its golden MPPI replan, kept honest as
``tests/test_torch_weights.py`` keeps the flagship's, with that file's checks
and tolerances.

``weights/ag_r5f_v2/golden_mppi_f32.npz`` is one f32 MPPI replan of the JAX
package (``FusedCEMPlanner(mppi=...)`` with the ``CorrelatedNoiseSampler``
defaults, anchored on the last executed action): 24 samples x 10 steps x 3
iterations, its normals and latents stored beside its inputs, scores, elites
and the first two elites' frames at steps 2, 5 and 8.  Write it where JAX
and orbax are installed (``tests/test_torch_weights.py --write`` writes the
exports and the Gaussian goldens)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_weights_ag.py --write
"""

import argparse
import os

import jax
import numpy as np
import pytest

from test_torch_planner import few_torch_threads  # noqa: F401
from test_torch_weights import (AG_R5F_V2, H, LIVE_ATOL, LIVE_RTOL,
                                PORT_ATOL, PORT_RTOL,
                                _check_export_bit_for_bit,
                                _check_golden_is_live, _check_port_replays,
                                _check_port_restores, _load, _restore_jax,
                                W)

# the CorrelatedNoiseSampler's defaults (4 stds: ag_r5f_v2's adim)
MPPI_GOLDEN = dict(num_samples=24, nactions=10, iterations=3, k_elite=6,
                   n_vis=2, finalweight=10.0, seed=13, kappa=1.0, beta_0=0.5,
                   beta_1=0.5, per_dim_std=(0.05, 0.05, 0.2, np.pi / 10))
MPPI_GOLDEN_PATH = os.path.join(AG_R5F_V2.export_dir, 'golden_mppi_f32.npz')
MPPI_VIS_STEPS = slice(2, None, 3)


def mppi_spec(gauss, g=MPPI_GOLDEN):
    """The control-cadence spec of the MPPI planner (``gauss``: the JAX or
    the port's ``planners.gaussian``)."""
    stds = tuple(float(s) for s in g['per_dim_std'])
    return gauss.ActionSpec(
        adim=len(stds), nactions=int(g['nactions']), repeat=1,
        per_dim_std=stds, clip_dims_xy=(), clip_dims_rot=(), rej_dims_xy=(),
        rej_dims_lift=(), xy_std=stds[0], lift_std=stds[2])


def mppi_config(g=MPPI_GOLDEN):
    return {'kappa': float(g['kappa']), 'beta_0': float(g['beta_0']),
            'beta_1': float(g['beta_1']), 'refit_cov': False,
            'mean_bias': None,
            'per_dim_std': tuple(float(s) for s in g['per_dim_std'])}


def mppi_inputs():
    """The MPPI golden's seeded context, goal, anchor and draws (the
    normals of each iteration's ``k_sample``, the latents of its
    ``k_model``)."""
    g, ex = MPPI_GOLDEN, AG_R5F_V2
    rng = np.random.RandomState(g['seed'])
    m, n = g['num_samples'], g['nactions']
    distribs = np.zeros((1, 2, H, W, 1), np.float32)
    distribs[:, :, 20, 40, 0] = 1.0
    ctx_actions = (rng.randn(1, ex.adim) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(g['seed'])
    noise, latents = [], []
    for _ in range(g['iterations']):
        key, k_sample, k_model, _ = jax.random.split(key, 4)
        noise.append(np.asarray(jax.random.normal(
            k_sample, (m, n, ex.adim))).reshape(m, -1))
        latents.append(np.asarray(jax.random.normal(
            k_model, (m, ex.latent_dim))))
    return {
        'images': rng.rand(1, 2, H, W, 3).astype(np.float32),
        'states': (rng.randn(2, ex.sdim) * 0.05).astype(np.float32),
        'distribs': distribs, 'ctx_actions': ctx_actions,
        'goal': np.array([[[30.0, 10.0]]], np.float32),
        'mean0': np.zeros(n * ex.adim, np.float32),
        'sigma0': np.eye(n * ex.adim, dtype=np.float32),
        'anchor': ctx_actions[-1], 'anchor_valid': np.float32(1.0),
        'noise': np.stack(noise).astype(np.float32),
        'latents': np.stack(latents).astype(np.float32),
    }


def jax_mppi_replan(jp, inputs):
    """The JAX package's f32 MPPI replan of the golden inputs."""
    from visual_foresight_tpu.planners import costs as jcosts
    from visual_foresight_tpu.planners import gaussian as jgauss
    from visual_foresight_tpu.planners.cem import FusedCEMPlanner
    g = MPPI_GOLDEN
    planner = FusedCEMPlanner(
        jp.model, mppi_spec(jgauss), g['num_samples'],
        iterations=g['iterations'], k_elite=g['k_elite'],
        finalweight=g['finalweight'], n_vis=g['n_vis'], mppi=mppi_config())
    out = planner.replan(
        jp.params, jax.random.PRNGKey(g['seed']), inputs['images'],
        inputs['states'], inputs['distribs'], inputs['ctx_actions'],
        jcosts.distance_grid(inputs['goal'], H, W), inputs['mean0'],
        inputs['sigma0'], anchor=inputs['anchor'],
        anchor_valid=float(inputs['anchor_valid']))
    scores = np.asarray(out['scores_per_itr'])
    return {
        'scores_per_itr': scores,
        'elite_idx': np.argsort(scores, axis=1, kind='stable')[
            :, :g['k_elite']],
        'best_actions': np.asarray(out['best_actions']),
        'mean': np.asarray(out['mean']),
        'vis_indices': np.asarray(out['vis']['indices']),
        'vis_gen_images': np.asarray(
            out['vis']['gen_images'])[:, MPPI_VIS_STEPS],
    }


def write_mppi_golden(jp):
    inputs = mppi_inputs()
    golden = dict(inputs, **jax_mppi_replan(jp, inputs))
    golden.update({k: np.asarray(v) for k, v in MPPI_GOLDEN.items()})
    np.savez_compressed(MPPI_GOLDEN_PATH, **golden)
    print('wrote {}'.format(MPPI_GOLDEN_PATH))


@pytest.fixture(scope='module')
def jax_ag_r5f_v2():
    return _restore_jax(AG_R5F_V2)


def test_ag_r5f_v2_export_equals_orbax_restore_bit_for_bit(jax_ag_r5f_v2):
    got = _check_export_bit_for_bit(AG_R5F_V2, jax_ag_r5f_v2)
    # the latent widens cond_proj alone: 5 states + 4 actions + 8 latents
    assert got['params/step/cond_proj/kernel'].shape == (17, 1024)
    assert got['params/step/state_head/kernel'].shape == (9, 5)


def test_port_restores_the_ag_r5f_v2_export():
    """``TorchPredictor(dir, {})`` adopts latent_dim 8, adim 4 and sdim 5
    from the export's ``model_config.json``."""
    tp = _check_port_restores(AG_R5F_V2)
    assert (tp._hp['latent_dim'], tp._hp['adim'], tp._hp['sdim']) == (8, 4, 5)
    assert tp.models[0].latent_dim == 8


def test_ag_r5f_v2_golden_equals_live_jax_replan(jax_ag_r5f_v2):
    golden = _load(AG_R5F_V2.golden_path)
    assert golden['latents'].shape == (3, 24, 8)
    _check_golden_is_live(AG_R5F_V2, jax_ag_r5f_v2, golden)


def test_port_replays_ag_r5f_v2_golden_on_cpu():
    _check_port_replays(AG_R5F_V2, _load(AG_R5F_V2.golden_path))


def test_mppi_golden_equals_live_jax_replan(jax_ag_r5f_v2):
    golden = _load(MPPI_GOLDEN_PATH)
    inputs = mppi_inputs()
    for key, value in inputs.items():
        np.testing.assert_array_equal(golden[key], value, err_msg=key)
    live = jax_mppi_replan(jax_ag_r5f_v2, inputs)
    np.testing.assert_allclose(golden['scores_per_itr'],
                               live['scores_per_itr'], rtol=LIVE_RTOL)
    for key in ('elite_idx', 'vis_indices'):
        np.testing.assert_array_equal(golden[key], live[key], err_msg=key)
    for key in ('best_actions', 'mean', 'vis_gen_images'):
        np.testing.assert_allclose(golden[key], live[key], atol=LIVE_ATOL,
                                   err_msg=key)
    assert os.path.getsize(MPPI_GOLDEN_PATH) < 512 * 1024


def test_port_replays_mppi_golden_on_cpu():
    """The port's MPPI planner on the export replays the JAX replan with its
    normals, latents and anchor injected: same elites, scores rtol 1e-5,
    plans, mean plan and frames atol 5e-5."""
    from visual_foresight_torch.planners import costs as tcosts
    from visual_foresight_torch.planners import gaussian as tgauss
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    golden = _load(MPPI_GOLDEN_PATH)
    tp = _check_port_restores(AG_R5F_V2)
    g = {k: int(golden[k]) for k in ('num_samples', 'iterations', 'k_elite',
                                     'n_vis')}
    planner = FusedCEMPlanner(
        mppi_spec(tgauss, golden), g['num_samples'],
        iterations=g['iterations'], k_elite=g['k_elite'],
        finalweight=float(golden['finalweight']), n_vis=g['n_vis'],
        mppi=mppi_config(golden), device='cpu')
    out = planner.replan(
        tp.models, golden['images'], golden['states'], golden['distribs'],
        golden['ctx_actions'], tcosts.distance_grid(golden['goal'], H, W),
        golden['mean0'], golden['sigma0'], noise=golden['noise'],
        latents=golden['latents'], anchor=golden['anchor'],
        anchor_valid=float(golden['anchor_valid']))
    scores = out['scores_per_itr'].numpy()
    np.testing.assert_allclose(scores, golden['scores_per_itr'],
                               rtol=PORT_RTOL)
    np.testing.assert_array_equal(
        np.argsort(scores, axis=1, kind='stable')[:, :g['k_elite']],
        golden['elite_idx'])
    np.testing.assert_array_equal(out['vis']['indices'].numpy(),
                                  golden['vis_indices'])
    for key, got in (('best_actions', out['best_actions']),
                     ('mean', out['mean']),
                     ('vis_gen_images',
                      out['vis']['gen_images'][:, MPPI_VIS_STEPS])):
        np.testing.assert_allclose(got.numpy(), golden[key], atol=PORT_ATOL,
                                   err_msg=key)


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--write', action='store_true',
                    help='write the golden MPPI replan')
    if ap.parse_args().write:
        jax.config.update('jax_platforms', 'cpu')
        write_mppi_golden(_restore_jax(AG_R5F_V2))
