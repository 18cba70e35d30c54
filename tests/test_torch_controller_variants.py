"""Port parity: every other planning cost, the port's controller against the
JAX package's side by side over a few ``act()`` steps at a small width
(``tests/test_torch_controller.py``'s space-to-depth predictor, 16x24
frames), both on the same perturbed weights:

- ``ClassifierController`` (goal-conditioned and not, two final frames) and
  ``NCECostController``, fused and in the host CEM loop;
- ``CEMControllerEnsembleVidPred``, members as copies of the one restore
  and from a list of member directories;
- ``RegisterGtruthController`` and ``InvModelBaseController``: in
  ``tests/test_torch_controller_registration.py``.

The fused replans get the normals of the JAX controller's key chain
injected (``tests/test_torch_controller.py``); the ensemble's host loop its
``sample_actions`` normals (``_draw_normals``); the host CEM loop samples
the same host draws on both sides (``tests/test_torch_host_loop.py``).
Tolerances: actions atol 1e-5, scores rtol 1e-4 with equal elites."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_controllers import AG_PARAMS, BASE_POLICY
from test_torch_aux_models import seeded
from test_torch_controller import PREDICTOR, _perturbed
from test_torch_host_loop import SEED, _frames, _pair
from test_torch_planner import _jax_replan_draws, _jax_sample_normals
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.models.convert import (flatten_flax,
                                                   load_flax_params)
from visual_foresight_torch.policy.cem_controllers.variants import (
    CEMControllerEnsembleVidPred, ClassifierController, NCECostController)
from visual_foresight_tpu.policy.cem_controllers.variants import (
    classifier_controller as jclf, ensemble_vidpred as jens,
    nce_cost_controller as jnce)

ACTION_ATOL = 1e-5
SCORE_RTOL = 1e-4
# 7 elites over the 6 plan dims: a refit of full rank
POLICY = dict(BASE_POLICY, predictor_hparams=PREDICTOR, num_samples=16,
              minimum_selection=7, iterations=2)


def inject_jax_draws(tctrl, latent_dim=0):
    """The port's fused replans draw the JAX controller's normals: its seed
    key, one split a replan, then the replan's own splits."""
    chain = {'rng': jax.random.PRNGKey(SEED)}
    replan, hp, spec = tctrl._fused.replan, tctrl._hp, tctrl._fused.spec

    def injected(*args, generator, num_samples=None, **kw):
        chain['rng'], sub = jax.random.split(chain['rng'])
        noise, latents, _ = _jax_replan_draws(
            sub, hp.iterations, num_samples or hp.num_samples,
            spec.nactions * spec.adim,
            rejection_rounds=10 if hp.rejection_sampling else 0,
            latent_dim=latent_dim)
        return replan(*args, noise=noise, latents=latents,
                      num_samples=num_samples, **kw)
    tctrl._fused.replan = injected


def side_by_side(jctrl, tctrl, steps, images, states, check=None, **act_kw):
    """Both controllers over the same frames; ``check(jctrl, tctrl)`` after
    each replan.  Returns the number of replans."""
    np.random.seed(SEED)
    jctrl.reset()
    tctrl.reset()
    replans = 0
    for t in range(steps):
        kw = dict(act_kw, t=t, i_tr=0, images=images[:t + 2],
                  state=states[:t + 2])
        want = jctrl.act(verbose_worker=None, **kw)
        got = tctrl.act(**kw)
        assert got['actions'].shape == want['actions'].shape
        np.testing.assert_allclose(got['actions'], want['actions'],
                                   atol=ACTION_ATOL, err_msg='t={}'.format(t))
        assert sorted(got['plan_stat']) == sorted(want['plan_stat'])
        for key, value in want['plan_stat'].items():
            np.testing.assert_allclose(got['plan_stat'][key], value,
                                       rtol=SCORE_RTOL, err_msg=key)
        if jctrl._t_since_replan == 0 and t >= tctrl._hp.start_planning:
            replans += 1
            np.testing.assert_array_equal(tctrl._best_indices,
                                          jctrl._best_indices)
            if check:
                check(jctrl, tctrl)
    return replans


def _goal_image(ncam=1, seed=7):
    return np.random.RandomState(seed).rand(1, ncam, 16, 24, 3).astype(
        np.float32)


# -- the classifier and NCE costs ----------------------------------------------
SCORERS = {
    'classifier': (jclf.ClassifierController, ClassifierController,
                   'classifier_params', 'classifier'),
    'nce': (jnce.NCECostController, NCECostController, 'embedding_params',
            'embedding'),
}


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'host_loop'])
@pytest.mark.parametrize('name,goal_conditioned', [
    ('classifier', True), ('classifier', False), ('nce', True)],
    ids=['classifier', 'classifier_no_goal', 'nce'])
def test_scoring_controller_matches_jax(name, goal_conditioned, fused):
    jcls, tcls, jattr, tattr = SCORERS[name]
    policy = dict(POLICY, final_frames=2)
    if not goal_conditioned:
        policy['goal_conditioned'] = False
    if not fused:
        policy['use_fused_planner'] = False
    jctrl, tctrl = _pair(jcls, tcls, AG_PARAMS, policy, policy)
    tree = seeded(getattr(jctrl, jattr), 21)
    setattr(jctrl, jattr, jax.tree.map(jnp.asarray, tree))
    load_flax_params(getattr(tctrl, tattr), tree)
    assert (tctrl._fused is not None) == fused == (jctrl._fused is not None)
    if fused:
        inject_jax_draws(tctrl)
    images, states = _frames(AG_PARAMS, 3, seed=6)
    assert side_by_side(jctrl, tctrl, 3, images, states,
                        goal_image=_goal_image()) == 2
    # the verbose dump (it raised until it was ported): the fused replan
    # dumps its last iteration, the host loop does not, as in JAX
    from test_torch_verbose import ListWorker
    worker = ListWorker()
    tctrl._hp.set_hparam('verbose', True)
    out = tctrl.act(t=1, i_tr=0, images=images[:3], state=states[:3],
                    goal_image=_goal_image(), verbose_worker=worker)
    assert np.isfinite(out['actions']).all()
    assert any(i[0] == 'txt_file' for i in worker.items) == fused


# -- the ensemble ----------------------------------------------------------------
ENS_POLICY = dict(POLICY, ensemble_var_lambda=2.0)    # 3 members
DESIG, GOAL = np.array([[[4, 6]]]), np.array([[[10, 18]]])


def _inject_ensemble_draws(tctrl):
    """``_draw_normals`` gives the normals of JAX's key chain: three splits
    an iteration, the first feeding ``sample_actions``."""
    chain = {'rng': jax.random.PRNGKey(SEED)}

    def draw(m, dim):
        chain['rng'], k1, _ = jax.random.split(chain['rng'], 3)
        return torch.tensor(_jax_sample_normals(k1, m, dim))
    tctrl._draw_normals = draw


def _member_dirs(root, trees):
    """One directory a member: ``view0/params.npz`` and the small
    predictor's ``model_config.json``."""
    paths = []
    cfg = {k: PREDICTOR[k] for k in ('num_masks', 'std_factor',
                                     'lstm_kernel', 'separable_lstm')}
    cfg['enc_features'] = list(PREDICTOR['enc_features'])
    for i, tree in enumerate(trees):
        path = os.path.join(str(root), 'member{}'.format(i))
        os.makedirs(os.path.join(path, 'view0'))
        np.savez(os.path.join(path, 'view0', 'params.npz'),
                 **flatten_flax(tree))
        with open(os.path.join(path, 'model_config.json'), 'w') as f:
            json.dump(cfg, f)
        paths.append(path)
    return paths


@pytest.mark.parametrize('members', ['copies', 'list'])
def test_ensemble_controller_matches_jax(members, tmp_path):
    jctrl, tctrl0 = _pair(jens.CEMControllerEnsembleVidPred,
                          CEMControllerEnsembleVidPred, AG_PARAMS,
                          ENS_POLICY, ENS_POLICY)
    p0 = jctrl.predictor.params[0]
    if members == 'copies':
        trees = [p0] * 3
        tctrl = tctrl0
        assert all(m is tctrl.predictor.models[0] for m in tctrl.members)
    else:
        trees = [p0] + [_perturbed(p0, 30 + i, scale=0.02)
                        for i in range(2)]
        trees = [jax.tree.map(np.asarray, t) for t in trees]
        tctrl = CEMControllerEnsembleVidPred(AG_PARAMS, dict(
            ENS_POLICY, seed=SEED, device='cpu',
            model_path=_member_dirs(tmp_path, trees)))
        assert tctrl.members_restored == [True] * 3
        assert tctrl.predictor.restored
    jctrl._ens_params = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    _inject_ensemble_draws(tctrl)
    images, states = _frames(AG_PARAMS, 3, seed=8)
    assert side_by_side(jctrl, tctrl, 3, images, states, desig_pix=DESIG,
                        goal_pix=GOAL) == 2
    if members == 'list':       # the members disagree
        first = [next(m.parameters()) for m in tctrl.members]
        assert not torch.equal(first[0], first[1])


def test_ensemble_member_count_must_match_the_paths(tmp_path):
    with pytest.raises(ValueError):
        CEMControllerEnsembleVidPred(AG_PARAMS, dict(
            ENS_POLICY, device='cpu', model_path=[str(tmp_path)] * 2))


def test_variants_export_the_three_controllers():
    from visual_foresight_torch.policy.cem_controllers import variants
    assert {'ClassifierController', 'CEMControllerEnsembleVidPred',
            'NCECostController'} <= set(dir(variants))
