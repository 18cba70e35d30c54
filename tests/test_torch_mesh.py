"""Port parity: ``visual_foresight_torch.parallel`` (the one-process mesh),
the planner's and the trainer's sharding over it, against the port's own
unsharded runs and the JAX package's sharded runs over the conftest's
virtual eight-device CPU mesh.

- A replan sharded over eight CPU entries at ``tests/test_planner.py``'s
  mesh test's model and sizes (16 samples, 2 iterations, 4 elites, 2
  videos), with a latent model (``ag_r5f_v2``'s ``latent_dim`` and ``adim``,
  seeded weights), JAX's draws injected: against the port's unsharded
  replan and JAX's sharded one, scores atol 1e-4, plans atol 1e-5, as that
  test holds JAX.  At a warm start's 12 samples, which do not divide the
  mesh (XLA pads the shares and gives the unsharded result; the port splits
  them unevenly), and over two distinct devices (``cpu`` and ``cpu:0``:
  the replicas are copies), against the port's unsharded replan (which
  ``tests/test_torch_planner.py`` holds against JAX's at both counts).
- Two data-parallel train steps at ``tests/test_training.py``'s sizes over
  eight CPU entries and over two distinct devices against the port's
  unsharded steps and JAX's sharded ones, JAX's scheduled-sampling masks
  injected: losses and every parameter atol 1e-5.
- ``train(--n_devices 2)`` logs the history of ``--n_devices 1`` (rtol
  1e-5: the loss is summed from the shares in another order).
- The mesh helpers, the planner's and ``shard_batch``'s refusals, the dry
  run at a small size, and (``slow``, as JAX's) the flagship's sharded
  replan at the serving geometry."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_planner import (_jax_replan_draws, few_torch_threads,  # noqa: F401
                                      small_models)
from visual_foresight_tpu.models.cdna import CDNAPredictor as JaxPredictor
from visual_foresight_tpu.parallel import mesh as jmesh
from visual_foresight_tpu.planners import costs as jcosts
from visual_foresight_tpu.planners import gaussian as jgauss
from visual_foresight_tpu.planners.cem import FusedCEMPlanner as JaxPlanner
from visual_foresight_tpu.training import train_predictor as jtrain
from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.models.convert import (flatten_flax,
                                                   load_flax_params,
                                                   params_to_flax)
from visual_foresight_torch.parallel.mesh import (Mesh, gather, make_mesh,
                                                  replicate, shard_batch,
                                                  shard_bounds)
from visual_foresight_torch.planners import costs as tcosts
from visual_foresight_torch.planners import gaussian as tgauss
from visual_foresight_torch.planners.cem import FusedCEMPlanner
from visual_foresight_torch.training import train_predictor as ttrain

SCORE_ATOL, ACTION_ATOL = 1e-4, 1e-5
LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-5
HISTORY_RTOL = 1e-5
HP = {'initial_std': 0.05, 'initial_std_lift': 0.15,
      'initial_std_rot': np.pi / 18, 'initial_std_grasp': 2,
      'action_order': ['x', 'z', 'grasp'], 'nactions': 3, 'repeat': 2}
CPU0 = torch.device('cpu', 0)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _two_devices(n=8):
    """``n`` entries alternating between ``cpu`` and ``cpu:0``: two devices
    to the mesh, so the second gets copies of the modules."""
    return Mesh(tuple(torch.device('cpu') if i % 2 == 0 else CPU0
                      for i in range(n)))


# -- the mesh helpers --------------------------------------------------------

def test_make_mesh_on_the_cpu_and_without_a_card():
    mesh = make_mesh(8, device='cpu')
    assert mesh.size == 8 and mesh.axis_names == ('data',)
    assert set(mesh.devices) == {torch.device('cpu')}
    assert make_mesh(device='cpu').size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make_mesh(2)


def test_shard_bounds_replicate_and_gather():
    mesh = make_mesh(4, device='cpu')
    assert shard_bounds(mesh, 8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert shard_bounds(mesh, 6) == [(0, 2), (2, 4), (4, 5), (5, 6)]
    assert shard_bounds(mesh, 3) == [(0, 1), (1, 2), (2, 3), (3, 3)]
    x = torch.arange(24.0).reshape(8, 3)
    pieces = shard_batch(mesh, {'x': x, 'pair': (x, None), 'n': 5})
    assert [tuple(p['x'].shape) for p in pieces] == [(2, 3)] * 4
    assert pieces[1]['pair'][1] is None and pieces[2]['n'] == 5
    assert torch.equal(gather(mesh, [p['x'] for p in pieces]), x)
    model = torch.nn.Linear(2, 2)
    assert all(m is model for m in replicate(mesh, model))
    copies = replicate(_two_devices(4), model)
    assert copies[0] is model and copies[2] is model
    assert copies[1] is copies[3] and copies[1] is not model
    assert torch.equal(copies[1].weight, model.weight)


def test_shard_batch_refuses_an_axis_that_does_not_divide():
    with pytest.raises(ValueError, match='does not divide'):
        shard_batch(make_mesh(4, device='cpu'), {'x': torch.zeros(6, 2)})


@pytest.mark.parametrize('kw,match', [
    (dict(num_samples=12), 'divide over'),
    (dict(num_samples=16, sample_chunk=8), 'separate regimes')],
    ids=['samples', 'sample_chunk'])
def test_planner_refuses_what_jax_asserts(kw, match):
    spec = tgauss.make_action_spec(HP, 3)
    with pytest.raises(ValueError, match=match):
        FusedCEMPlanner(spec, k_elite=4, mesh=make_mesh(8, device='cpu'),
                        **kw)


# -- the sharded replan ------------------------------------------------------

def _jax_mesh_model():
    """``tests/test_planner.py``'s mesh test: model, params and context."""
    model = JaxPredictor(n_context=2, num_masks=4, num_distribs=1, sdim=3,
                         adim=3, enc_features=(8, 16, 32))
    key = jax.random.PRNGKey(0)
    h, w = 16, 24
    imgs = jax.random.uniform(key, (1, 2, h, w, 3))
    states = jnp.zeros((1, 2, 3))
    distribs = jnp.zeros((1, 2, h, w, 1)).at[:, :, 8, 12, 0].set(1.0)
    params = model.init(key, imgs, jnp.zeros((1, 7, 3)), states, distribs)
    tmodel = CDNAPredictor((h, w), n_context=2, num_masks=4, num_distribs=1,
                           sdim=3, adim=3, enc_features=(8, 16, 32))
    load_flax_params(tmodel, jax.tree.map(np.asarray, params))
    goal = np.array([[[4.0, 20.0]]], np.float32)
    return (model, [params], [tmodel], np.asarray(imgs[0]),
            np.zeros((2, 3), np.float32), np.asarray(distribs[0]),
            np.zeros((1, 3), np.float32), goal, HP, 0)


def _latent_model():
    """A latent model at ``ag_r5f_v2``'s ``latent_dim`` 8, ``adim`` 4 and
    ``sdim`` 5, narrow, with seeded weights."""
    (jmodel, cam_params, tmodels, images, states, distribs, actions,
     goal) = small_models(adim=4, sdim=5, latent_dim=8)
    return (jmodel, cam_params, tmodels, images[0], states, distribs[0],
            actions, goal, dict(HP, action_order=None), 8)


# (model maker, sample count of the replan, mesh maker, against JAX's
# sharded replan too)
REPLAN_CASES = {
    'repeated': (_jax_mesh_model, None, lambda: make_mesh(8, device='cpu'),
                 True),
    'latent': (_latent_model, None, lambda: make_mesh(8, device='cpu'),
               True),
    'warm_start_12': (_jax_mesh_model, 12,
                      lambda: make_mesh(8, device='cpu'), False),
    'two_devices': (_jax_mesh_model, None, _two_devices, False),
}


@pytest.mark.parametrize('case', list(REPLAN_CASES))
def test_sharded_replan_matches_unsharded_and_jax(case):
    make_models, n, make, with_jax = REPLAN_CASES[case]
    (jmodel, cam_params, tmodels, images, states, distribs, actions, goal,
     hp, latent_dim) = make_models()
    h, w = images.shape[1:3]
    adim = actions.shape[-1]
    jspec, tspec = jgauss.make_action_spec(hp, adim), \
        tgauss.make_action_spec(hp, adim)
    dim = tspec.nactions * tspec.adim
    mean0 = np.zeros(dim, np.float32)
    sigma0 = np.asarray(jgauss.initial_sigma(jspec))
    key = jax.random.PRNGKey(3)
    m = n or 16
    kw = dict(num_samples=16, iterations=2, k_elite=4, n_vis=2)

    noise, latents, _ = _jax_replan_draws(key, 2, m, dim,
                                          latent_dim=latent_dim)

    def port(mesh):
        planner = FusedCEMPlanner(tspec, mesh=mesh, device='cpu', **kw)
        return planner.replan(tmodels, images[None], states, distribs[None],
                              actions, tcosts.distance_grid(goal, h, w),
                              mean0, sigma0, noise=noise, latents=latents,
                              num_samples=n)

    got, plain = port(make()), port(None)
    refs = [plain]
    if with_jax:
        refs.append(JaxPlanner(jmodel, jspec, mesh=jmesh.make_mesh(8),
                               **kw).replan(
            cam_params, key, images[None], states, distribs[None], actions,
            jcosts.distance_grid(goal, h, w), mean0, sigma0, num_samples=n))
    for ref in refs:
        np.testing.assert_allclose(_np(got['scores_per_itr']),
                                   _np(ref['scores_per_itr']),
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(_np(got['best_scores']),
                                   _np(ref['best_scores']), atol=SCORE_ATOL)
        np.testing.assert_allclose(_np(got['best_actions']),
                                   _np(ref['best_actions']),
                                   atol=ACTION_ATOL)
        np.testing.assert_array_equal(_np(got['vis']['indices']),
                                      _np(ref['vis']['indices']))
        np.testing.assert_allclose(_np(got['vis']['gen_distribs']),
                                   _np(ref['vis']['gen_distribs']),
                                   atol=SCORE_ATOL)
    assert tuple(got['scores_per_itr'].shape) == (2, m)


# -- the data-parallel train step --------------------------------------------

TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_W = 8, 4, 16, 24
TRAIN_STEPS = 2


_JAX_STEPS = []


def _jax_sharded_steps():
    """``tests/test_training.py``'s sharded step, taken twice (keys 1 and
    2): per step the loss, the scheduled-sampling mask its loss drew, and
    the parameters after the steps; with the batch and the initial
    parameters.  Cached: one compile for the module."""
    if _JAX_STEPS:
        return _JAX_STEPS[0]
    model = JaxPredictor(n_context=2, num_masks=4, num_distribs=0, sdim=3,
                         adim=3, enc_features=(8, 16, 32))
    rng = np.random.RandomState(0)
    B, T, H, W = TRAIN_B, TRAIN_T, TRAIN_H, TRAIN_W
    batch = {
        'images': rng.rand(B, T, H, W, 3).astype(np.float32),
        'actions': (rng.randn(B, T - 1, 3) * 0.1).astype(np.float32),
        'states': (rng.randn(B, T, 3) * 0.1).astype(np.float32),
    }
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = model.init(jax.random.PRNGKey(0), jb['images'][:, :2],
                        jb['actions'], jb['states'][:, :2])
    init = jax.tree.map(np.asarray, params)
    tx = optax.adam(1e-3)
    mesh = jmesh.make_mesh(8)
    bsh, rsh = jmesh.batch_sharding(mesh), jmesh.replicated(mesh)
    step = jax.jit(jtrain.make_train_step(model, tx, n_context=2),
                   in_shardings=(rsh, rsh, bsh, rsh, rsh),
                   out_shardings=(rsh, rsh, rsh))
    params = jmesh.replicate(mesh, params)
    opt_state = jmesh.replicate(mesh, tx.init(params))
    losses, masks = [], []
    for i in range(TRAIN_STEPS):
        key = jax.random.PRNGKey(1 + i)
        params, opt_state, metrics = step(
            params, opt_state, jmesh.shard_batch(mesh, jb),
            jax.device_put(key, rsh), jnp.asarray(float(i)))
        losses.append(float(metrics['loss']))
        rng_ss, _ = jax.random.split(key)
        masks.append(np.asarray(jtrain.scheduled_sampling_mask(
            rng_ss, jnp.asarray(float(i)), T - 1, B, 2)))
    _JAX_STEPS.append((batch, init, losses, masks, flatten_flax(
        jax.tree.map(np.asarray, params))))
    return _JAX_STEPS[0]


def _port_steps(init, batch, masks, mesh):
    model = CDNAPredictor((TRAIN_H, TRAIN_W), n_context=2, num_masks=4,
                          num_distribs=0, sdim=3, adim=3,
                          enc_features=(8, 16, 32))
    load_flax_params(model, init)
    tx = ttrain.adam(ttrain._named_params(model), 1e-3)
    step = ttrain.make_train_step(model, tx, 2, mesh=mesh)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    losses = [float(step(tb, i, gt_mask=torch.tensor(mask))['loss'])
              for i, mask in enumerate(masks)]
    return losses, flatten_flax(params_to_flax(model.state_dict()))


@pytest.mark.parametrize('make', [lambda: make_mesh(8, device='cpu'),
                                  _two_devices],
                         ids=['repeated', 'two_devices'])
def test_dp_train_steps_match_unsharded_and_jax(make):
    batch, init, jax_losses, masks, jax_params = _jax_sharded_steps()
    losses, params = _port_steps(init, batch, masks, make())
    plain_losses, plain_params = _port_steps(init, batch, masks, None)
    for ref_losses, ref_params in ((plain_losses, plain_params),
                                   (jax_losses, jax_params)):
        np.testing.assert_allclose(losses, ref_losses, atol=LOSS_ATOL)
        assert set(params) == set(ref_params)
        for name, value in params.items():
            np.testing.assert_allclose(value, ref_params[name],
                                       atol=PARAM_ATOL, err_msg=name)


def _history(n_devices):
    args = ttrain.build_argparser().parse_args(
        ['--batch_size', '4', '--sequence_length', '5', '--image_height',
         '16', '--image_width', '16', '--num_masks', '3', '--enc_features',
         '8', '16', '16', '--lstm_kernel', '3', '--ss_k', '2', '--steps',
         '3', '--log_every', '1', '--device', 'cpu', '--n_devices',
         str(n_devices)])
    history, trainer = ttrain.train(args)
    return history, trainer


def test_train_over_two_devices_logs_the_history_of_one(capsys):
    one, _ = _history(1)
    two, trainer = _history(2)
    assert trainer.mesh.size == 2
    assert 'mesh devices: cpu, cpu' in capsys.readouterr().out
    assert len(one) == len(two) == 3
    for a, b in zip(one, two):
        assert a['step'] == b['step']
        for k in a:
            if k not in ('step', 'sec'):
                np.testing.assert_allclose(b[k], a[k], rtol=HISTORY_RTOL,
                                           err_msg=k)


# -- the dry run and the flagship ------------------------------------------

def test_dryrun_multichip_on_the_cpu(capsys):
    from visual_foresight_torch.tools import dryrun_multichip
    assert dryrun_multichip.main(['--device', 'cpu', '--n_devices', '2',
                                  '--no_flagship']) == 0
    out = capsys.readouterr().out
    assert 'dryrun_multichip(2) mesh devices: cpu, cpu' in out
    assert 'dryrun_multichip(2) train step ok' in out
    assert 'dryrun_multichip(2) sharded replan ok' in out
    assert 'FLAGSHIP' not in out


@pytest.mark.slow
def test_sharded_flagship_replan_matches_unsharded():
    """The serving point: 48x64, 200 samples, bf16, the restored flagship,
    eight CPU entries against unsharded, at JAX's flagship tolerances."""
    from visual_foresight_torch.parallel.flagship_check import (
        flagship_replan)
    sharded, predictor = flagship_replan(mesh=make_mesh(8, device='cpu'),
                                         iterations=2)
    assert predictor.restored
    plain, _ = flagship_replan(iterations=2, predictor=predictor,
                               device='cpu')
    np.testing.assert_allclose(_np(sharded['scores_per_itr'][0]),
                               _np(plain['scores_per_itr'][0]), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(_np(sharded['best_actions']),
                               _np(plain['best_actions']), atol=1e-4)
    scores = _np(sharded['best_scores'])
    assert np.all(np.isfinite(scores)) and np.all(np.diff(scores) >= -1e-6)
