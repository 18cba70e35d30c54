"""Seeded numpy exports of the JAX package's default predictor (the classic
Finn-CDNA backbone) and of its DNA twin, each with a golden replan of the
JAX package at those weights, for machines that have no JAX.

No checkpoint of these architectures exists, so each export is
``CDNAPredictor.init`` of ``TPUPredictor``'s default hparams (48x64,
``enc_features`` (32, 64, 128), separable 5x5 LSTM gates, SNA, 10 masks of
5x5, one designated pixel; ``dna`` on for the twin) plus seeded numpy noise
(scale 0.1) on every leaf, so that no bias or LayerNorm parameter is at its
initial value.  ``visual_foresight_torch/weights/<name>/`` holds
``view0/params.npz`` (the flax tree flattened with '/'-joined keys, f32),
``model_config.json`` (as ``training/train_predictor.py`` writes it) and
``golden_replan_f32.npz``: one f32 ``FusedCEMPlanner`` replan of 24 samples
x 15 steps x 3 iterations with 20 elites over the 15 plan dims (with 16, 16
points in 15 dims, the refit was of full rank but so badly conditioned
that the two frameworks' Cholesky factors put the last iteration's plans
8e-5 apart), normals injected, with its inputs, scores, elites and the
first two elites' frames at the last step of each action block.  Write them
where JAX is installed::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_weights_classic.py --write

The tests keep the files honest, with ``tests/test_torch_weights.py``'s
checks and tolerances: each export equals the seeded JAX parameters bit for
bit; each golden equals a live JAX replan (scores rtol 1e-5, actions and
frames atol 1e-5); the port restores each export with the right parameter
count and replays each golden on the CPU in f32 with the same elites
(scores rtol 1e-5, actions and frames atol 5e-5).
"""

import argparse
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import few_torch_threads  # noqa: F401
from test_torch_weights import (H, W, Export, _check_golden_is_live,
                                _check_port_replays, _check_port_restores,
                                _load, flatten_params, golden_inputs,
                                jax_golden_replan)

PERTURB_SEED, PERTURB_SCALE = 40, 0.1
GOLDEN = dict(num_samples=24, nactions=5, repeat=3, iterations=3, k_elite=20,
              n_vis=2, finalweight=10.0)
# xz_bench20's sampling widths, as the flagship's golden has them
SPEC_HP = {'initial_std': 0.05, 'initial_std_lift': 0.15,
           'initial_std_rot': np.pi / 18, 'initial_std_grasp': 2,
           'action_order': ['x', 'z', 'grasp']}
CLASSIC_CDNA = Export('classic_cdna', adim=3, sdim=3, latent_dim=0,
                      n_params=2004891, golden=dict(GOLDEN, seed=41),
                      spec_hp=SPEC_HP)
CLASSIC_DNA = Export('classic_dna', adim=3, sdim=3, latent_dim=0,
                     n_params=469466, golden=dict(GOLDEN, seed=42),
                     spec_hp=SPEC_HP)
EXPORTS = {CLASSIC_CDNA: False, CLASSIC_DNA: True}     # export: dna


def model_config(dna):
    """``model_config.json`` of an export, in the trainer's form
    (``training/train_predictor.py::model_config_dict``) with its
    defaults."""
    return {'context_frames': 2, 'num_masks': 10, 'kernel_size': 5,
            'sna': True, 'dna': dna, 'latent_dim': 0, 'lstm_kernel': 5,
            'separable_lstm': True, 'std_factor': 0,
            'enc_features': [32, 64, 128], 'dtype': 'bfloat16', 'adim': 3,
            'sdim': 3, 'sequence_length': 15, 'img_dims': [H, W],
            'stochastic': False}


@functools.lru_cache(maxsize=None)
def seeded_jax_predictor(dna):
    """``TPUPredictor`` with its default hparams in f32 (``dna`` on or
    off) on the seeded, perturbed parameters of the export (made once a
    process: the tests only read it)."""
    from visual_foresight_tpu.prediction.predictor import TPUPredictor
    jp = TPUPredictor('unused', {'img_dims': (H, W), 'dtype': 'float32',
                                 'dna': dna})
    params = jp._init_params(seed=0)
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(PERTURB_SEED + int(dna))
    return jp.set_params([jax.tree.unflatten(tree, [
        x + jnp.asarray(rng.randn(*x.shape).astype(np.float32) *
                        PERTURB_SCALE) for x in leaves])])


def write_exports():
    for ex, dna in EXPORTS.items():
        jp = seeded_jax_predictor(dna)
        os.makedirs(os.path.dirname(ex.params_path), exist_ok=True)
        flat = flatten_params(jp.params[0])
        np.savez(ex.params_path, **flat)
        with open(os.path.join(ex.export_dir, 'model_config.json'), 'w') as f:
            json.dump(model_config(dna), f, indent=1)
        inputs = golden_inputs(ex)
        golden = dict(inputs, **jax_golden_replan(jp, inputs, ex))
        golden.update({k: np.asarray(v) for k, v in ex.golden.items()})
        np.savez_compressed(ex.golden_path, **golden)
        print('wrote {} ({} leaves, {} parameters) and {}'.format(
            ex.params_path, len(flat), sum(v.size for v in flat.values()),
            ex.golden_path))


@pytest.mark.parametrize('ex', list(EXPORTS), ids=lambda ex: ex.name)
def test_export_equals_the_seeded_jax_parameters(ex):
    want = flatten_params(seeded_jax_predictor(EXPORTS[ex]).params[0])
    got = _load(ex.params_path)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32 == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert sum(v.size for v in got.values()) == ex.n_params
    with open(os.path.join(ex.export_dir, 'model_config.json')) as f:
        assert json.load(f) == model_config(EXPORTS[ex])


@pytest.mark.parametrize('ex', list(EXPORTS), ids=lambda ex: ex.name)
def test_port_restores_the_export(ex):
    tp = _check_port_restores(ex)
    assert tp._hp['std_factor'] == 0 and tp._hp['dna'] == EXPORTS[ex]
    assert hasattr(tp.models[0].step, 'lstm5')


@pytest.mark.parametrize('ex', list(EXPORTS), ids=lambda ex: ex.name)
def test_golden_equals_live_jax_replan(ex):
    _check_golden_is_live(ex, seeded_jax_predictor(EXPORTS[ex]),
                          _load(ex.golden_path))


@pytest.mark.parametrize('ex', list(EXPORTS), ids=lambda ex: ex.name)
def test_port_replays_golden_on_cpu(ex):
    _check_port_replays(ex, _load(ex.golden_path))


def test_classic_goldens_stay_small():
    for ex in EXPORTS:
        assert os.path.getsize(ex.golden_path) < 512 * 1024, ex.name


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--write', action='store_true',
                    help='write the seeded exports and their golden replans')
    if ap.parse_args().write:
        jax.config.update('jax_platforms', 'cpu')
        write_exports()
