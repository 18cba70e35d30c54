"""Seeded numpy exports of the planning costs' networks, and a JAX golden of
each controller that uses one, for machines that have no JAX.

No trained checkpoint of these networks is in the repository, so each
export is the JAX network's ``init`` at its default widths plus seeded
noise (``models/convert.py::perturbed_flat``: std 0.3 of each leaf's
spread, at least 0.03, so that no bias is zero):

- ``weights/seeded_gdn/``: ``GoalDistanceNet()`` (32, 64, 128);
- ``weights/seeded_classifier/``: ``SuccessClassifier()`` (32, 64, 128,
  256), goal-conditioned;
- ``weights/seeded_nce/``: ``NCEEmbedding()`` (32, 64, 128, 256; 128);
- ``weights/seeded_inverse/``: ``InverseNet(3, 7)`` with two context
  frames.

Each holds ``params.npz`` (the flax tree flattened with '/'-joined keys,
f32), ``net_config.json`` and a golden in f32.  A controller golden is one
JAX replan through the controller's ``act()`` at t=1 (48x64, 24 samples, 5
actions x repeat 3, 3 iterations, more elites than plan dims) with its
inputs, the policy and agent (JSON), the normals (and latents) the JAX
controller drew, its scores, elites and action:

- ``seeded_gdn/golden_registration_f32.npz``: ``RegisterGtruthController``
  with two cameras; view 0 is ``weights/xz_flagship``, view 1 a copy of it
  with seeded noise (std 0.1 of each leaf's spread; the seed is in the
  golden, the copy is not committed); also the tradeoffs and the
  registered pixels;
- ``seeded_classifier/golden_classifier_f32.npz``: ``ClassifierController``
  on ``weights/ag_r5f_v2`` (its latents injected), three final frames;
- ``seeded_nce/golden_nce_f32.npz``: ``NCECostController`` on the flagship;
- ``xz_flagship/golden_ensemble_f32.npz``: ``CEMControllerEnsembleVidPred``,
  the flagship and two seeded copies of it as the members;
- ``seeded_inverse/golden_inverse_f32.npz``: the inverse net's plans on
  four seeded inputs.

Write them where JAX is installed::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_weights_aux.py --write

The tests: each export equals the seeded JAX parameters bit for bit; the
port restores each (``restored``) with the right parameter count; the port
replays each golden on the CPU in f32 through the controller (scores rtol
1e-4 with the same elites; actions rtol 1e-4 and atol 5e-5: the last
iteration samples from a refit of 20 elites over 15 plan dims, whose
Cholesky factor carries the scores' relative error into the grasp dim,
std 2; measured 3.4e-5 relative on the NCE golden; the inverse plans atol
1e-5), and the inverse golden equals a live JAX call.
"""

import argparse
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_planner import _jax_replan_draws, _jax_sample_normals
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.models.convert import (flatten_flax,
                                                   perturbed_flat, read_npz,
                                                   restore_network,
                                                   unflatten_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, 'visual_foresight_torch', 'weights')
FLAGSHIP = os.path.join(WEIGHTS, 'xz_flagship')
AG_R5F_V2 = os.path.join(WEIGHTS, 'ag_r5f_v2')
H, W = 48, 64
NET_SCALE, NET_FLOOR = 0.3, 0.1
COPY_SCALE = 0.1
SCORE_RTOL, ACTION_ATOL, INVERSE_ATOL = 1e-4, 5e-5, 1e-5
# name -> (net_config.json, noise seed, parameter count)
NETS = {
    'seeded_gdn': ({'features': [32, 64, 128], 'flow_scale': 10.0}, 51,
                   214322),
    'seeded_classifier': ({'features': [32, 64, 128, 256],
                           'goal_conditioned': True}, 52, 422305),
    'seeded_nce': ({'features': [32, 64, 128, 256], 'embed_dim': 128}, 53,
                   421312),
    'seeded_inverse': ({'adim': 3, 'plan_T': 7, 'num_context': 2}, 54,
                       134261),
}
XZ_AGENT = {'adim': 3, 'sdim': 3, 'ncam': 1, 'image_height': H,
            'image_width': W, 'T': 15}
XZ_SPEC = {'action_order': ['x', 'z', 'grasp'], 'initial_std_lift': 0.5,
           'rejection_sampling': False, 'num_samples': 24,
           'minimum_selection': 20,
           'predictor_hparams': {'dtype': 'float32'}}
# name -> (golden path, agent, policy without paths, act() inputs); every
# policy plans the controllers' default 5 actions x repeat 3 (T 15)
NACTIONS = 5
GOLDENS = {
    'ensemble': (os.path.join(FLAGSHIP, 'golden_ensemble_f32.npz'),
                 XZ_AGENT, dict(XZ_SPEC, seed=61, ensemble_var_lambda=2.0),
                 ('desig_pix', 'goal_pix')),
    'registration': (
        os.path.join(WEIGHTS, 'seeded_gdn', 'golden_registration_f32.npz'),
        dict(XZ_AGENT, ncam=2, ntask=1),
        dict(XZ_SPEC, seed=62, predictor_hparams={'dtype': 'float32',
                                                  'ncam': 2}),
        ('desig_pix', 'goal_pix', 'goal_image')),
    'classifier': (
        os.path.join(WEIGHTS, 'seeded_classifier',
                     'golden_classifier_f32.npz'),
        dict(XZ_AGENT, adim=4, sdim=5),
        # ag_bench20_classifier's widths; 21 elites over the 20 plan dims
        {'initial_std': 0.04, 'initial_std_rot': np.pi / 32,
         'initial_std_lift': 0.6, 'rejection_sampling': False,
         'num_samples': 24, 'minimum_selection': 21,
         'final_frames': 3, 'seed': 63,
         'predictor_hparams': {'dtype': 'float32'}},
        ('goal_image',)),
    'nce': (os.path.join(WEIGHTS, 'seeded_nce', 'golden_nce_f32.npz'),
            XZ_AGENT, dict(XZ_SPEC, seed=64), ('goal_image',)),
}
COPY_SEEDS = {'ensemble': (71, 72), 'registration': (73,)}
INVERSE_GOLDEN = os.path.join(WEIGHTS, 'seeded_inverse',
                              'golden_inverse_f32.npz')


def _jax_net(name):
    """(JAX network, its init inputs) at 48x64."""
    from visual_foresight_tpu.models import classifier, gdn, inverse
    frame = jnp.zeros((1, H, W, 3))
    return {
        'seeded_gdn': (gdn.GoalDistanceNet(), (frame, frame)),
        'seeded_classifier': (classifier.SuccessClassifier(),
                              (frame, frame)),
        'seeded_nce': (classifier.NCEEmbedding(), (frame,)),
        'seeded_inverse': (inverse.InverseNet(3, 7), (
            frame, frame, jnp.zeros((1, 2, H, W, 3)))),
    }[name]


def seeded_jax_flat(name):
    """The export's parameters: the JAX ``init`` plus seeded noise."""
    net, args = _jax_net(name)
    flat = flatten_flax(jax.tree.map(
        np.asarray, net.init(jax.random.PRNGKey(0), *args)))
    return perturbed_flat(flat, NETS[name][1], NET_SCALE, NET_FLOOR)


def _torch_net(name):
    from visual_foresight_torch.models import classifier, gdn, inverse
    return {'seeded_gdn': gdn.GoalDistanceNet,
            'seeded_classifier': classifier.SuccessClassifier,
            'seeded_nce': classifier.NCEEmbedding,
            'seeded_inverse': lambda: inverse.InverseNet(3, 7, 2)}[name]()


def predictor_dirs(kind, root, seeds):
    """The predictor directories of a golden's controller: the ensemble's
    member list (the flagship, then its seeded copies) or the two-camera
    registration predictor (view 1 a seeded copy); ``None`` for the
    others, which read a vendored export."""
    if not len(seeds):
        return None
    flagship = read_npz(os.path.join(FLAGSHIP, 'view0', 'params.npz'))
    copies = [perturbed_flat(flagship, int(s), COPY_SCALE) for s in seeds]

    def write(path, views):
        for v, flat in enumerate(views):
            os.makedirs(os.path.join(path, 'view{}'.format(v)))
            np.savez(os.path.join(path, 'view{}'.format(v), 'params.npz'),
                     **flat)
        shutil.copyfile(os.path.join(FLAGSHIP, 'model_config.json'),
                        os.path.join(path, 'model_config.json'))
        return path
    if kind == 'ensemble':
        return [FLAGSHIP] + [write(os.path.join(root, 'member{}'.format(i)),
                                   [c]) for i, c in enumerate(copies)]
    return write(os.path.join(root, 'xz2c'), [flagship] + copies)


def golden_inputs(kind, agent):
    """The seeded frames, states, pixels and goal image of a golden."""
    rng = np.random.RandomState(80)
    ncam = agent['ncam']
    return {
        'images': (rng.rand(2, ncam, H, W, 3) * 255).astype(np.uint8),
        'states': (rng.randn(2, agent['sdim']) * 0.05).astype(np.float32),
        'desig_pix': np.array([[[24, 32]], [[30, 20]]][:ncam]),
        'goal_pix': np.array([[[10, 50]], [[15, 40]]][:ncam]),
        'goal_image': rng.rand(1, ncam, H, W, 3).astype(np.float32),
    }


def _jax_controller(kind, agent, policy, dirs):
    """The JAX controller of a golden on the export's weights."""
    from visual_foresight_tpu.policy.cem_controllers import \
        registration_controller as jreg
    from visual_foresight_tpu.policy.cem_controllers.variants import (
        classifier_controller as jclf, ensemble_vidpred as jens,
        nce_cost_controller as jnce)
    tree = lambda flat: jax.tree.map(jnp.asarray, unflatten_flax(flat))
    view0 = read_npz(os.path.join(AG_R5F_V2 if kind == 'classifier'
                                  else FLAGSHIP, 'view0', 'params.npz'))
    cls = {'ensemble': jens.CEMControllerEnsembleVidPred,
           'registration': jreg.RegisterGtruthController,
           'classifier': jclf.ClassifierController,
           'nce': jnce.NCECostController}[kind]
    path = dirs if kind == 'registration' else \
        AG_R5F_V2 if kind == 'classifier' else FLAGSHIP
    extra = {'registration': {'gdn_path': ''}}.get(kind, {})
    ctrl = cls(agent, dict(policy, model_path=path, **extra))
    views = [view0]
    if kind == 'registration':
        views.append(read_npz(os.path.join(dirs, 'view1', 'params.npz')))
        ctrl.gdn_params = tree(seeded_jax_flat('seeded_gdn'))
    ctrl.predictor.set_params([tree(v) for v in views])
    if kind == 'ensemble':
        members = [tree(read_npz(os.path.join(d, 'view0', 'params.npz')))
                   for d in dirs]
        ctrl._ens_params = jax.tree.map(lambda *xs: jnp.stack(xs), *members)
    if kind == 'classifier':
        ctrl.classifier_params = tree(seeded_jax_flat('seeded_classifier'))
    if kind == 'nce':
        ctrl.embedding_params = tree(seeded_jax_flat('seeded_nce'))
    return ctrl


def jax_golden(kind):
    """One JAX replan of a controller golden, with its inputs and draws."""
    path, agent, policy, act_keys = GOLDENS[kind]
    inputs = golden_inputs(kind, agent)
    root = tempfile.mkdtemp()
    try:
        ctrl = _jax_controller(kind, agent, policy, predictor_dirs(
            kind, root, COPY_SEEDS.get(kind, ())))
        ctrl.reset()
        out = ctrl.act(t=1, i_tr=0, images=inputs['images'],
                       state=inputs['states'], verbose_worker=None,
                       **{k: inputs[k] for k in act_keys})
    finally:
        shutil.rmtree(root)
    adim = agent['adim']
    m, iters = policy['num_samples'], 3
    dim = NACTIONS * adim
    key = jax.random.PRNGKey(policy['seed'])
    latents = None
    if kind == 'ensemble':
        noise = []
        for _ in range(iters):
            key, k1, _ = jax.random.split(key, 3)
            noise.append(_jax_sample_normals(k1, m, dim))
        noise = np.stack(noise)
    else:
        _, sub = jax.random.split(key)
        noise, latents, _ = _jax_replan_draws(
            sub, iters, m, dim, latent_dim=8 if kind == 'classifier' else 0)
    golden = dict(inputs, noise=noise.astype(np.float32),
                  policy=np.array(json.dumps(policy)),
                  agent=np.array(json.dumps(agent)),
                  copy_seeds=np.array(COPY_SEEDS.get(kind, ()), np.int64),
                  copy_scale=np.float32(COPY_SCALE),
                  scores_per_itr=np.stack([out['plan_stat'][
                      'scores_itr{}'.format(i)] for i in range(iters)]),
                  best_indices=np.asarray(ctrl._best_indices),
                  best_actions=np.asarray(ctrl._best_actions),
                  action=np.asarray(out['actions']))
    if latents is not None:
        golden['latents'] = latents.astype(np.float32)
    if kind == 'registration':
        golden['tradeoff'] = np.asarray(ctrl.reg_tradeoff)
        golden['desig_registered'] = np.asarray(ctrl._desig_pix)
    return golden


def inverse_inputs():
    """Four seeded inputs of the inverse net (frames of whole 8-bit
    steps, which keeps the golden small)."""
    rng = np.random.RandomState(81)
    frames = lambda *s: rng.randint(0, 256, s).astype(np.float32) / 255.0
    return {'current': frames(4, H, W, 3), 'goal': frames(4, H, W, 3),
            'context': frames(4, 2, H, W, 3)}


def jax_inverse_golden():
    net, _ = _jax_net('seeded_inverse')
    params = unflatten_flax(seeded_jax_flat('seeded_inverse'))
    inputs = inverse_inputs()
    plans = np.concatenate([np.asarray(net.apply(
        params, inputs['current'][i:i + 1], inputs['goal'][i:i + 1],
        inputs['context'][i:i + 1])) for i in range(4)])
    return dict(inputs, plans=plans)


def write_exports():
    for name, (config, _, _) in NETS.items():
        out = os.path.join(WEIGHTS, name)
        os.makedirs(out, exist_ok=True)
        flat = seeded_jax_flat(name)
        np.savez(os.path.join(out, 'params.npz'), **flat)
        with open(os.path.join(out, 'net_config.json'), 'w') as f:
            json.dump(config, f, indent=1)
        print('wrote {} ({} parameters)'.format(out, sum(
            v.size for v in flat.values())))
    for kind, (path, _, _, _) in GOLDENS.items():
        np.savez_compressed(path, **jax_golden(kind))
        print('wrote', path)
    np.savez_compressed(INVERSE_GOLDEN, **jax_inverse_golden())
    print('wrote', INVERSE_GOLDEN)


# -- the port's side ---------------------------------------------------------------
def port_controller(kind, golden, root, device='cpu'):
    """The port's controller of a golden, its weights restored."""
    from visual_foresight_torch.policy.cem_controllers.registration_controller \
        import RegisterGtruthController
    from visual_foresight_torch.policy.cem_controllers.variants import (
        CEMControllerEnsembleVidPred, ClassifierController,
        NCECostController)
    agent = json.loads(str(golden['agent']))
    policy = json.loads(str(golden['policy']))
    policy['device'] = device
    dirs = predictor_dirs(kind, root, golden['copy_seeds'])
    if kind == 'ensemble':
        ctrl = CEMControllerEnsembleVidPred(agent, dict(policy,
                                                        model_path=dirs))
        assert ctrl.members_restored == [True] * 3
    elif kind == 'registration':
        ctrl = RegisterGtruthController(agent, dict(
            policy, model_path=dirs,
            gdn_path=os.path.join(WEIGHTS, 'seeded_gdn')))
        assert ctrl.gdn_restored
    elif kind == 'classifier':
        ctrl = ClassifierController(agent, dict(
            policy, model_path=AG_R5F_V2,
            classifier_path=os.path.join(WEIGHTS, 'seeded_classifier')))
        assert ctrl.classifier_restored
    else:
        ctrl = NCECostController(agent, dict(
            policy, model_path=FLAGSHIP,
            embedding_path=os.path.join(WEIGHTS, 'seeded_nce')))
        assert ctrl.embedding_restored
    assert ctrl.predictor.restored
    return ctrl


def replay(kind, golden, ctrl):
    """The golden's replan through the port's ``ctrl`` with its draws."""
    noise = torch.as_tensor(golden['noise'])
    if kind == 'ensemble':
        draws = iter(noise)
        ctrl._draw_normals = lambda m, dim: next(draws).to(ctrl.device)
    else:
        replan = ctrl._fused.replan
        ctrl._fused.replan = lambda *a, generator, **kw: replan(
            *a, noise=noise, latents=golden.get('latents'), **kw)
    agent = json.loads(str(golden['agent']))
    act_keys = GOLDENS[kind][3]
    ctrl.reset()
    return ctrl.act(t=1, i_tr=0, images=golden['images'],
                    state=golden['states'],
                    **{k: golden[k] for k in act_keys}), agent


@pytest.mark.parametrize('name', sorted(NETS))
def test_export_equals_the_seeded_jax_parameters(name):
    want = seeded_jax_flat(name)
    got = read_npz(os.path.join(WEIGHTS, name, 'params.npz'))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32 == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert sum(v.size for v in got.values()) == NETS[name][2]
    with open(os.path.join(WEIGHTS, name, 'net_config.json')) as f:
        assert json.load(f) == NETS[name][0]


@pytest.mark.parametrize('name', sorted(NETS))
def test_port_restores_the_export(name):
    net = _torch_net(name)
    assert restore_network(net, os.path.join(WEIGHTS, name))
    assert sum(p.numel() for p in net.parameters()) == NETS[name][2]


@pytest.mark.parametrize('kind', sorted(GOLDENS))
def test_port_replays_controller_golden_on_cpu(kind, tmp_path):
    golden = read_npz(GOLDENS[kind][0])
    ctrl = port_controller(kind, golden, str(tmp_path))
    out, agent = replay(kind, golden, ctrl)
    scores = np.stack([out['plan_stat']['scores_itr{}'.format(i)]
                       for i in range(golden['scores_per_itr'].shape[0])])
    np.testing.assert_allclose(scores, golden['scores_per_itr'],
                               rtol=SCORE_RTOL)
    np.testing.assert_array_equal(ctrl._best_indices, golden['best_indices'])
    np.testing.assert_allclose(ctrl._best_actions, golden['best_actions'],
                               rtol=SCORE_RTOL, atol=ACTION_ATOL)
    np.testing.assert_allclose(out['actions'], golden['action'],
                               rtol=SCORE_RTOL, atol=ACTION_ATOL)
    assert out['actions'].shape == (agent['adim'],)
    if kind == 'registration':
        np.testing.assert_allclose(ctrl.reg_tradeoff, golden['tradeoff'],
                                   rtol=SCORE_RTOL)
        np.testing.assert_array_equal(ctrl._desig_pix,
                                      golden['desig_registered'])


def test_port_replays_inverse_golden_on_cpu():
    from visual_foresight_torch.policy.inverse_models. \
        inverse_model_base_controller import TorchInverseModel
    golden = read_npz(INVERSE_GOLDEN)
    model = TorchInverseModel(os.path.join(WEIGHTS, 'seeded_inverse'),
                              {'adim': 3, 'plan_T': 7, 'num_context': 2},
                              device='cpu').restore()
    assert model.restored
    for i in range(4):
        got = model(golden['current'][i], golden['goal'][i], None,
                    golden['context'][i:i + 1])
        np.testing.assert_allclose(got, golden['plans'][i:i + 1],
                                   atol=INVERSE_ATOL)


def test_inverse_golden_equals_live_jax():
    golden, live = read_npz(INVERSE_GOLDEN), jax_inverse_golden()
    for key, value in live.items():
        np.testing.assert_allclose(golden[key], value, atol=INVERSE_ATOL,
                                   err_msg=key)


def test_aux_files_stay_small():
    paths = [os.path.join(WEIGHTS, n, f) for n in NETS
             for f in ('params.npz', 'net_config.json')]
    paths += [g[0] for g in GOLDENS.values()] + [INVERSE_GOLDEN]
    for path in paths:
        assert os.path.getsize(path) < 2 * 1024 * 1024, path


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--write', action='store_true',
                    help='write the seeded exports and their goldens')
    if ap.parse_args().write:
        jax.config.update('jax_platforms', 'cpu')
        write_exports()
