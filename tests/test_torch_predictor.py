"""Port parity: ``TorchPredictor.__call__`` against ``TPUPredictor.__call__``
at a small width, with and without the per-rollout latent, on two cameras.

Both run the model's teacher-forced forward over the context action followed
by the plan, so the latent conditions the context step too (the fused
planner's ``encode_context`` uses zeros there).  The latent is the one the
JAX predictor draws from its key, ``normal(rng, (M, latent_dim))``, shared by
the cameras, made again here and handed to the port.

Tolerance: 1e-4 (f32, the small model's tolerance of
``tests/test_torch_cdna_model.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.models.convert import params_from_flax
from visual_foresight_torch.prediction import predictor as tpred
from visual_foresight_tpu.prediction.predictor import TPUPredictor

TOL = 1e-4
H, W, M, T_PLAN, NCAM = 16, 24, 3, 4, 2


def _hparams(latent_dim):
    return {'designated_pixel_count': 1, 'ncam': NCAM, 'img_dims': (H, W),
            'adim': 4, 'sdim': 5, 'latent_dim': latent_dim, 'num_masks': 4,
            'dtype': 'float32', 'std_factor': 4, 'enc_features': (8, 16, 16),
            'lstm_kernel': 3, 'separable_lstm': True,
            'sequence_length': T_PLAN + 2}


def _predictors(latent_dim, tmp_path):
    """Both predictors on the same seeded, perturbed weights (one set per
    camera); ``tmp_path`` holds no checkpoint, so both start from a seeded
    initialization."""
    jp = TPUPredictor(str(tmp_path), _hparams(latent_dim)).restore()
    rng = np.random.RandomState(30)
    perturbed = []
    for p in jp.params:
        leaves, tree = jax.tree.flatten(p)
        perturbed.append(jax.tree.unflatten(tree, [
            x + jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1)
            for x in leaves]))
    jp.set_params(perturbed)
    with pytest.warns(UserWarning, match='seeded random weights'):
        tp = tpred.TorchPredictor(str(tmp_path), _hparams(latent_dim),
                                  device='cpu').restore()
    assert not tp.restored
    tp.set_params([params_from_flax(jax.tree.map(np.asarray, p))
                   for p in perturbed])
    return jp, tp


def _context(rng):
    return {
        'context_frames': rng.rand(2, NCAM, H, W, 3).astype(np.float32),
        'context_actions': (rng.randn(3, 4) * 0.1).astype(np.float32),
        'context_states': (rng.randn(2, 5) * 0.1).astype(np.float32),
        'context_pixel_distributions':
            rng.rand(2, NCAM, H, W, 1).astype(np.float32),
    }, {'actions': (rng.randn(M, T_PLAN, 4) * 0.1).astype(np.float32)}


@pytest.mark.parametrize('latent_dim', [4, 0])
def test_predictor_call_matches_jax(latent_dim, tmp_path):
    jp, tp = _predictors(latent_dim, tmp_path)
    context, action_dict = _context(np.random.RandomState(31))
    key = jax.random.PRNGKey(32)
    want = jp(context, action_dict, rng=key)
    latent = np.asarray(jax.random.normal(key, (M, latent_dim))) \
        if latent_dim else None
    got = tp(context, action_dict, latent=latent)
    for name in ('predicted_frames', 'predicted_pixel_distributions'):
        assert got[name].shape == want[name].shape
        assert got[name].shape[:3] == (M, T_PLAN, NCAM)
        np.testing.assert_allclose(got[name], want[name], atol=TOL,
                                   err_msg=name)


def test_predictor_call_conditions_the_context_step_on_the_latent(tmp_path):
    """The reference's property: ``__call__`` differs from ``encode_context``
    + ``rollout_from`` under the same latent, because the latter conditions
    the context step on zeros."""
    _, tp = _predictors(4, tmp_path)
    context, action_dict = _context(np.random.RandomState(33))
    latent = np.random.RandomState(34).randn(M, 4).astype(np.float32)
    got = tp(context, action_dict, latent=latent)['predicted_frames']
    frames = torch.tensor(np.swapaxes(context['context_frames'], 0, 1))
    distribs = torch.tensor(np.swapaxes(
        context['context_pixel_distributions'], 0, 1))
    with torch.no_grad():
        carry = tp.models[0].encode_context(
            frames[0][None].expand(M, -1, -1, -1, -1),
            torch.tensor(context['context_actions'][-1:])[None].expand(
                M, -1, -1),
            torch.tensor(context['context_states'])[None].expand(M, -1, -1),
            distribs[0][None].expand(M, -1, -1, -1, -1))
        split = tp.models[0].rollout_from(
            carry, torch.tensor(action_dict['actions']),
            latent=torch.tensor(latent))['gen_images'].numpy()
    assert np.abs(got[:, :, 0] - split).max() > 10 * TOL
    zeros = tp(context, action_dict, latent=np.zeros((M, 4), np.float32))
    with torch.no_grad():
        split0 = tp.models[0].rollout_from(
            carry, torch.tensor(action_dict['actions']))['gen_images']
    np.testing.assert_allclose(zeros['predicted_frames'][:, :, 0],
                               split0.numpy(), atol=TOL)


def test_predictor_call_default_latent_seed(tmp_path):
    """With neither generator nor latent, the latent comes from a generator
    seeded with ``DEFAULT_LATENT_SEED`` (not zeros): the same call twice
    gives the same frames, and they are those of that explicit generator."""
    _, tp = _predictors(4, tmp_path)
    context, action_dict = _context(np.random.RandomState(35))
    first = tp(context, action_dict)['predicted_frames']
    again = tp(context, action_dict)['predicted_frames']
    gen = torch.Generator().manual_seed(tpred.DEFAULT_LATENT_SEED)
    explicit = tp(context, action_dict, generator=gen)['predicted_frames']
    zeros = tp(context, action_dict,
               latent=np.zeros((M, 4), np.float32))['predicted_frames']
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(first, explicit)
    assert np.abs(first - zeros).max() > 10 * TOL
