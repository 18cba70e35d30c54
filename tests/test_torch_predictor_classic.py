"""Port parity of the serving layer on the JAX package's default
architecture: ``TorchPredictor`` built from the default hparams with no
``model_config.json`` (the classic Finn-CDNA backbone at full width, and
its DNA twin) against ``TPUPredictor`` on the same seeded tree; the
adoption of every architecture key of ``model_config.json``; one Gaussian
replan of ``FusedCEMPlanner`` on small classic models (two CEM iterations,
normals injected); and ``prediction/pred_util.py``.

Tolerances: the predictor 1e-4 (f32, 48x64, the small model's tolerance of
``tests/test_torch_cdna_model.py``: the classic model's 64- and 128-channel
sums are no longer than its); the replan as
``tests/test_torch_planner.py``'s (scores rtol 1e-4, equal elites);
``pred_util`` exactly (the same numpy)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_planner import _check_replan_against_jax
from test_torch_weights_classic import few_torch_threads  # noqa: F401
from visual_foresight_torch.models.convert import params_from_flax
from visual_foresight_torch.prediction import pred_util as tpu_util
from visual_foresight_torch.prediction import predictor as tpred
from visual_foresight_tpu.prediction import pred_util as jpu_util
from visual_foresight_tpu.prediction.predictor import TPUPredictor

TOL = 1e-4
M, T_PLAN = 3, 3


def _predictors(tmp_path, hparams):
    """Both predictors on the same seeded, perturbed weights; ``tmp_path``
    holds neither a checkpoint nor a ``model_config.json``."""
    jp = TPUPredictor(str(tmp_path), hparams).restore()
    assert not jp.restored
    rng = np.random.RandomState(50)
    leaves, tree = jax.tree.flatten(jp.params[0])
    params = jax.tree.unflatten(tree, [
        x + jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1)
        for x in leaves])
    jp.set_params([params])
    with pytest.warns(UserWarning, match='seeded random weights'):
        tp = tpred.TorchPredictor(str(tmp_path), hparams,
                                  device='cpu').restore()
    tp.set_params([params_from_flax(jax.tree.map(np.asarray, params))])
    return jp, tp


@pytest.mark.parametrize('dna', [False, True], ids=['cdna', 'dna'])
def test_default_predictor_is_the_classic_backbone_and_matches_jax(
        dna, tmp_path):
    hparams = {'dtype': 'float32', 'sequence_length': T_PLAN + 2}
    if dna:
        hparams['dna'] = True
    jp, tp = _predictors(tmp_path, hparams)
    step = tp.models[0].step
    assert tp._hp['std_factor'] == 0 and hasattr(step, 'lstm5')
    assert hasattr(step, 'dna_head') == dna != hasattr(step, 'cdna_head')
    rng = np.random.RandomState(51)
    context = {
        'context_frames': rng.rand(2, 1, 48, 64, 3).astype(np.float32),
        'context_actions': (rng.randn(2, 3) * 0.1).astype(np.float32),
        'context_states': (rng.randn(2, 3) * 0.1).astype(np.float32),
        'context_pixel_distributions':
            rng.rand(2, 1, 48, 64, 1).astype(np.float32),
    }
    action_dict = {'actions': (rng.randn(M, T_PLAN, 3) * 0.1).astype(
        np.float32)}
    want = jp(context, action_dict)
    got = tp(context, action_dict)
    for name in ('predicted_frames', 'predicted_pixel_distributions'):
        assert got[name].shape == want[name].shape
        assert got[name].shape[:3] == (M, T_PLAN, 1)
        np.testing.assert_allclose(got[name], want[name], atol=TOL,
                                   err_msg=name)


def test_model_config_is_adopted_for_every_architecture_key(tmp_path):
    """Every ``_ARCH_KEYS`` value of ``model_config.json`` overrides the
    hparams, as ``TPUPredictor`` adopts it; the serving choices stay."""
    cfg = {'context_frames': 3, 'num_masks': 4, 'kernel_size': 3,
           'sna': False, 'dna': True, 'latent_dim': 2, 'lstm_kernel': 3,
           'separable_lstm': False, 'adim': 4, 'sdim': 5, 'std_factor': 4,
           'enc_features': [8, 16, 16], 'dtype': 'bfloat16',
           'img_dims': [16, 24]}
    assert set(tpred._ARCH_KEYS) < set(cfg)
    with open(tmp_path / 'model_config.json', 'w') as f:
        json.dump(cfg, f)
    hparams = {'dtype': 'float32', 'img_dims': (16, 24),
               'fuse_decode': True}
    jp = TPUPredictor(str(tmp_path), hparams)
    jp._apply_model_config()
    tp = tpred.TorchPredictor(str(tmp_path), hparams, device='cpu')
    for key in tpred._ARCH_KEYS:
        want = tuple(cfg[key]) if key == 'enc_features' else cfg[key]
        assert tp._hp[key] == jp._hp[key] == want, key
    assert tp._hp['dtype'] == 'float32'         # a serving choice
    step = tp.model.step
    assert step.dna and not step.sna and step.fuse_decode
    assert tp.model.latent_dim == 2 and tp.n_context == 3


@pytest.mark.parametrize('model_kw', [
    dict(std_factor=0), dict(std_factor=0, dna=True, num_masks=4)],
    ids=['classic', 'classic-dna'])
def test_classic_replan_matches_jax(model_kw):
    """``FusedCEMPlanner`` on a small classic model, two CEM iterations,
    JAX's normals injected (``tests/test_torch_planner.py``)."""
    _check_replan_against_jax(iters=2, k_elite=7, model_kw=model_kw)


class _Recorder:
    """A predictor with the reference's keyword interface: returns its
    actions' running sums as images, distributions and states."""

    def __init__(self):
        self.batches = []

    def __call__(self, input_images, input_state, input_actions,
                 input_one_hot_images):
        self.batches.append(np.array(input_actions))
        c = np.cumsum(input_actions, axis=1)
        return c * 2.0, c + input_images.sum(), c[..., :1]


@pytest.mark.parametrize('n,b_size', [(7, 3), (6, 3), (2, 5)])
def test_rollout_predictions_matches_jax(n, b_size):
    rng = np.random.RandomState(n)
    actions = rng.randn(n, 4, 2).astype(np.float32)
    frames = rng.rand(1, 2, 4, 4, 3).astype(np.float32)
    outs = []
    for util in (jpu_util, tpu_util):
        rec = _Recorder()
        outs.append((util.rollout_predictions(rec, b_size, actions, frames),
                     rec.batches))
    (want, want_batches), (got, got_batches) = outs
    assert len(got_batches) == len(want_batches) == max(1, -(-n // b_size))
    for g, w in zip(got_batches, want_batches):
        np.testing.assert_array_equal(g, w)
        assert g.shape == (b_size, 4, 2)
    for g_list, w_list in zip(got, want):
        assert sum(x.shape[0] for x in g_list) == n
        for g, w in zip(g_list, w_list):
            np.testing.assert_array_equal(g, w)


class _Hp:
    state_append = [0.41, 0.25]


@pytest.mark.parametrize('hp', [None, _Hp()], ids=['plain', 'state_append'])
def test_get_context_matches_jax(hp):
    rng = np.random.RandomState(3)
    images = (rng.rand(6, 1, 4, 5, 3) * 255).astype(np.uint8)
    state = rng.randn(6, 3).astype(np.float32)
    want = jpu_util.get_context(2, 4, state, images, hp)
    got = tpu_util.get_context(2, 4, state, images, hp)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (1, 2, 1, 4, 5, 3)
    assert got[1].shape == (1, 2, 3 + (2 if hp else 0))
