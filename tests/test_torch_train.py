"""Port parity: ``visual_foresight_torch.training.train_predictor`` against
the JAX package's trainer on the CPU.

- The schedules and the clipped AdamW against optax's; the scheduled
  sampling mask and the KL ramp against JAX's; the synthetic batches bit for
  bit.
- Whole train steps at small widths, deterministic and stochastic, on the
  classic backbone (full-resolution masks) and the space-to-depth one
  (blocked masks), and a latent model drawing from the prior: JAX's loss
  function and optax chain (``make_loss_fn`` and the chain ``train``
  builds, composed as ``make_train_step`` composes them, with the gradients
  returned too: one compile a case) take three steps from JAX's initial
  parameters; the port takes them from the same parameters with JAX's
  draws injected (the scheduled-sampling mask and the latent noise, made
  from the same key splits).  Losses, metrics, every gradient leaf (through
  ``params_to_flax``) and every parameter after the three updates.
- ``params_to_flax`` inverts ``params_from_flax``; a run resumes with its
  optimizer state (JAX's ``tests/test_training.py`` resume test); a trained
  checkpoint serves from ``TorchPredictor``; the entries without a backward
  kernel raise under grad on a kernel path.

Tolerances (f32): losses and metrics rtol 1e-5 (the same sums in another
order); gradients 1e-4 of each leaf's largest magnitude (rounding carried
back through four recurrent steps); parameters after three updates 2e-3 of
each leaf's largest change (Adam divides each gradient by its own root mean
square, so a gradient near the rounding level moves by a full step on
either side); the schedules and the optimizer on given gradients rtol 1e-6
(f32 scalars in another order)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_tpu.models.cdna import CDNAPredictor as JaxPredictor
from visual_foresight_tpu.models.latent import PosteriorEncoder as JaxPosterior
from visual_foresight_tpu.training import train_predictor as jtrain
from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.models.convert import (flatten_flax,
                                                   load_flax_params,
                                                   params_from_flax,
                                                   params_to_flax,
                                                   unflatten_flax)
from visual_foresight_torch.models.latent import PosteriorEncoder
from visual_foresight_torch.ops import cdna_tail
from visual_foresight_torch.prediction.predictor import TorchPredictor
from visual_foresight_torch.training import train_predictor as ttrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, 'visual_foresight_torch', 'weights')
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 2e-3
SCALAR_RTOL = 1e-6
B, SEQ, H, W = 2, 5, 16, 16
FEATURES = (8, 16, 16)
SS_K = 2.0                 # the mask then mixes ground truth and predictions
LR, STEPS = 1e-3, 3

# (id, model options, stochastic, uint8 images)
CASES = {
    'classic': (dict(std_factor=0), False, False),
    'std-blocked': (dict(std_factor=4), False, True),
    'std-stochastic': (dict(std_factor=4, latent_dim=4), True, False),
    'classic-stochastic': (dict(std_factor=0, latent_dim=4), True, False),
    'std-prior-latent': (dict(std_factor=2, latent_dim=4), False, False),
}
KL = dict(kl_beta=0.5, kl_anneal=(0.0, 2.0), kl_free_nats=0.1)


def _args(**kw):
    argv = ['--batch_size', str(B), '--sequence_length', str(SEQ),
            '--image_height', str(H), '--image_width', str(W),
            '--num_masks', '3', '--enc_features', *map(str, FEATURES),
            '--lstm_kernel', '3', '--device', 'cpu']
    for key, value in kw.items():
        argv += ['--' + key] + ([] if value is True else [str(value)])
    return ttrain.build_argparser().parse_args(argv)


def _model_kw(opts):
    return dict(n_context=2, num_masks=3, num_distribs=0, sdim=3, adim=3,
                enc_features=FEATURES, lstm_kernel=3, separable_lstm=True,
                **opts)


def _batch(uint8):
    batch = next(jtrain.synthetic_batches(_args(), seed=3))
    if uint8:
        batch['images'] = np.round(batch['images'] * 255).astype(np.uint8)
    return batch


def _draws(key, step, latent_dim):
    """The scheduled-sampling mask and the latent noise JAX's loss draws
    from ``key`` at ``step``."""
    rng_ss, rng_latent = jax.random.split(key)
    mask = jtrain.scheduled_sampling_mask(rng_ss, jnp.asarray(float(step)),
                                          SEQ - 1, B, 2, k=SS_K)
    eps = jax.random.normal(rng_latent, (B, latent_dim)) if latent_dim \
        else None
    return np.asarray(mask), None if eps is None else np.asarray(eps)


_RUNS = {}


def _run(case):
    """Three train steps of both trainers from JAX's initial parameters;
    cached per case.  Returns per step JAX's and the port's metrics and
    step-0 gradients (flat flax keys), and both parameter trees after the
    three updates."""
    if case in _RUNS:
        return _RUNS[case]
    opts, stochastic, uint8 = CASES[case]
    latent = opts.get('latent_dim', 0)
    batch = _batch(uint8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxPredictor(**_model_kw(opts))
    images0 = jnp.zeros((1, 2, H, W, 3))
    params = jm.init(jax.random.PRNGKey(0), images0,
                     jnp.zeros((1, SEQ - 1, 3)), jnp.zeros((1, 2, 3)))
    tm = CDNAPredictor((H, W), **_model_kw(opts))
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    jpost = tpost = None
    loss_kw = dict(ss_k=SS_K, **(KL if stochastic else {}))
    if stochastic:
        jpost = JaxPosterior(latent_dim=latent, features=FEATURES)
        pparams = jpost.init(jax.random.PRNGKey(1),
                             jnp.zeros((1, SEQ, H, W, 3)))
        params = {'model': params, 'posterior': pparams}
        tpost = PosteriorEncoder(latent, FEATURES)
        load_flax_params(tpost, jax.tree.map(np.asarray, pparams))

    schedule = optax.warmup_cosine_decay_schedule(
        0.0, LR, warmup_steps=min(200, STEPS // 10 + 1),
        decay_steps=max(STEPS, 2))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(schedule, weight_decay=1e-5))
    loss_fn = jtrain.make_loss_fn(jm, 2, posterior=jpost, **loss_kw)

    @jax.jit
    def jax_step(params, opt_state, batch, rng, step):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch, rng, step)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics['grad_norm'] = optax.global_norm(grads)
        return params, opt_state, metrics, grads

    ttx = ttrain.ClippedAdamW(ttrain._named_params(tm, tpost),
                              ttrain.training_schedule(_args(steps=STEPS)))
    tstep = ttrain.make_train_step(tm, ttx, 2, posterior=tpost, **loss_kw)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    opt_state = tx.init(params)
    steps = []
    for step in range(STEPS):
        key = jax.random.PRNGKey(100 + step)
        params, opt_state, jmet, jgrads = jax_step(
            params, opt_state, jb, key, jnp.asarray(float(step)))
        mask, eps = _draws(key, step, latent)
        tmet = tstep(tb, step, gt_mask=torch.tensor(mask),
                     eps=None if eps is None else torch.tensor(eps))
        tgrads = {}
        for key_, module in (('model', tm), ('posterior', tpost)):
            if module is not None:
                tgrads[key_] = flatten_flax(params_to_flax(
                    {n: p.grad for n, p in module.named_parameters()}))
        jg = jax.tree.map(np.asarray, jgrads)
        jg = {'model': flatten_flax(jg['model']),
              'posterior': flatten_flax(jg['posterior'])} if stochastic \
            else {'model': flatten_flax(jg)}
        steps.append({'jax': {k: float(v) for k, v in jmet.items()},
                      'port': {k: float(v) for k, v in tmet.items()},
                      'jax_grads': jg, 'port_grads': tgrads})
    jp = jax.tree.map(np.asarray, params)
    init = jm.init(jax.random.PRNGKey(0), images0,
                   jnp.zeros((1, SEQ - 1, 3)), jnp.zeros((1, 2, 3)))
    result = {
        'steps': steps,
        'jax_params': flatten_flax(jp['model'] if stochastic else jp),
        'port_params': flatten_flax(params_to_flax(tm.state_dict())),
        'init_params': flatten_flax(jax.tree.map(np.asarray, init)),
    }
    if stochastic:
        result['jax_posterior'] = flatten_flax(jp['posterior'])
        result['port_posterior'] = flatten_flax(
            params_to_flax(tpost.state_dict()))
        result['init_posterior'] = flatten_flax(jax.tree.map(
            np.asarray, pparams))
    _RUNS[case] = result
    return result


# -- schedules, clip, optimizer ----------------------------------------------

@pytest.mark.parametrize('steps', [3, 50, 1000, 3000])
def test_schedule_matches_optax(steps):
    want = optax.warmup_cosine_decay_schedule(
        0.0, 1e-3, warmup_steps=min(200, steps // 10 + 1),
        decay_steps=max(steps, 2))
    got = ttrain.training_schedule(_args(steps=steps, lr=1e-3))
    counts = sorted(set(range(0, 5)) | {steps // 10, steps // 10 + 1,
                                        steps // 2, steps - 1, steps,
                                        steps + 7})
    for c in counts:
        np.testing.assert_allclose(float(got(c)), float(want(c)),
                                   rtol=SCALAR_RTOL, atol=1e-12)
    assert float(got(0)) == 0.0


def test_clipped_adamw_matches_optax_on_given_gradients():
    """Four updates on gradients of norm above and below the clip, with a
    bf16 parameter updated through its f32 copy against optax on the f32
    value."""
    rng = np.random.RandomState(0)
    shapes = {'a': (3, 4), 'b': (5,), 'c': (2, 2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(schedule, weight_decay=1e-5))
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    ttx = ttrain.ClippedAdamW(list(tparams.items()),
                              ttrain.warmup_cosine_decay_schedule(
                                  0.0, 1e-2, 2, 6))
    jp = params
    for i, scale in enumerate((3.0, 0.1, 2.0, 0.5)):
        grads = {k: (scale * rng.randn(*s) / 3).astype(np.float32)
                 for k, s in shapes.items()}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tparams.items():
            p.grad = torch.tensor(grads[k])
        norm = ttx.step()
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(grads)),
                                   rtol=SCALAR_RTOL)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=SCALAR_RTOL,
                                       atol=1e-7)
    assert ttx.count == 4


def test_scheduled_sampling_mask_and_kl_ramp_match_jax(monkeypatch):
    """The mask from JAX's uniforms (handed to the port's draw), early and
    late in the decay; context steps always forced; the KL ramp."""
    for step, k in ((0.0, 100.0), (150.0, 100.0), (2000.0, 100.0),
                    (5.0, 2.0)):
        key = jax.random.PRNGKey(int(step))
        want = jtrain.scheduled_sampling_mask(key, jnp.asarray(step), 10, 64,
                                              2, k=k)
        uniforms = torch.tensor(np.asarray(jax.random.uniform(key, (64, 10))))
        monkeypatch.setattr(torch, 'rand', lambda *a, **kw: uniforms)
        got = ttrain.scheduled_sampling_mask(None, step, 10, 64, 2, k=k)
        monkeypatch.undo()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got[:, :2].min()) == 1.0
    for step in (0, 3, 7, 12, 30):
        want = jtrain.kl_beta_schedule(jnp.asarray(float(step)), 1e-4, 5.0,
                                       20.0)
        got = ttrain.kl_beta_schedule(step, 1e-4, 5.0, 20.0)
        np.testing.assert_allclose(float(got), float(want),
                                   rtol=SCALAR_RTOL)


def test_synthetic_batches_match_jax_bit_for_bit():
    args = _args(batch_size=3, sequence_length=6, adim=4, sdim=5)
    jb, tb = jtrain.synthetic_batches(args, seed=7), \
        ttrain.synthetic_batches(args, seed=7)
    for _ in range(3):
        want, got = next(jb), next(tb)
        assert set(want) == set(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# -- train steps against JAX ------------------------------------------------

@pytest.mark.parametrize('case', list(CASES))
def test_loss_and_metrics_match_jax(case):
    """Every metric of the three steps: loss, image and state L2, PSNR,
    grad_norm and, stochastic, the KL and its weight (the uint8 case's
    images normalized as JAX does)."""
    for step in _run(case)['steps']:
        assert set(step['port']) == set(step['jax'])
        for k, want in step['jax'].items():
            np.testing.assert_allclose(step['port'][k], want,
                                       rtol=LOSS_RTOL, atol=1e-12,
                                       err_msg=k)


@pytest.mark.parametrize('case', list(CASES))
def test_gradients_per_leaf_match_jax(case):
    """Every gradient leaf of every step, the port's through
    ``params_to_flax``."""
    for step in _run(case)['steps']:
        for module, want in step['jax_grads'].items():
            got = step['port_grads'][module]
            assert set(got) == set(want)
            for leaf, w in want.items():
                scale = max(float(np.abs(w).max()), 1e-12)
                err = float(np.abs(got[leaf] - w).max())
                assert err <= GRAD_TOL * scale, (module, leaf, err, scale)


@pytest.mark.parametrize('case', list(CASES))
def test_params_after_three_steps_match_jax(case):
    """Every parameter after three updates of the whole optax chain (update
    0 moves nothing: the schedule starts at 0)."""
    run = _run(case)
    pairs = [('jax_params', 'port_params', 'init_params')]
    if CASES[case][1]:
        pairs.append(('jax_posterior', 'port_posterior', 'init_posterior'))
    for jkey, tkey, ikey in pairs:
        want, got, init = run[jkey], run[tkey], run[ikey]
        assert set(got) == set(want)
        for leaf, w in want.items():
            change = float(np.abs(w - init[leaf]).max())
            assert change > 0, leaf
            err = float(np.abs(got[leaf] - w).max())
            assert err <= PARAM_TOL * change, (leaf, err, change)


# -- checkpoints ------------------------------------------------------------

@pytest.mark.parametrize('name', ['xz_flagship', 'ag_r5f_v2', 'classic_cdna',
                                  'classic_dna'])
def test_params_to_flax_inverts_params_from_flax(name):
    with np.load(os.path.join(WEIGHTS, name, 'view0', 'params.npz')) as f:
        flat = {k: f[k] for k in f.files}
    back = flatten_flax(params_to_flax(params_from_flax(unflatten_flax(flat))))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape
        np.testing.assert_array_equal(back[k], v)


def test_resume_restores_opt_state(tmp_path, capsys):
    """--resume continues from the saved step with the optimizer state
    restored (JAX's ``tests/test_training.py`` resume test): the count and
    the moments as saved; without the optimizer state it warns and
    fast-forwards the count."""
    common = dict(model_dir=str(tmp_path), batch_size=2, sequence_length=5,
                  num_masks=2, log_every=1)
    train_args = _args(steps=3, ckpt_every=2, **common)
    _, first = ttrain.train(train_args)
    assert os.path.isfile(os.path.join(str(tmp_path), 'opt',
                                       ttrain.OPT_FILE))
    saved = {k: {n: v.clone() for n, v in m.items()} if isinstance(m, dict)
             else m for k, m in first.tx.state().items()}
    capsys.readouterr()

    resumed = ttrain.make_trainer(_args(steps=5, resume=True, **common))
    start = ttrain._restore(_args(steps=5, resume=True, **common),
                            resumed.model, None, resumed.tx)
    assert start == 3 and resumed.tx.count == saved['count'] == 3
    for moment in ('mu', 'nu'):
        for n, v in saved[moment].items():
            assert torch.equal(resumed.tx.state()[moment][n], v), n
    for (n, p), q in zip(first.model.named_parameters(),
                         resumed.model.parameters()):
        assert torch.equal(p, q), n

    history, _ = ttrain.train(_args(steps=5, resume=True, **common))
    out = capsys.readouterr().out
    assert 'resumed opt state at step 3' in out
    # continued from step 3: only steps 3 and 4 run
    steps = [h['step'] for h in history]
    assert steps[0] >= 3 and steps[-1] == 4

    os.remove(os.path.join(str(tmp_path), 'opt', ttrain.OPT_FILE))
    fresh = ttrain.make_trainer(_args(steps=8, **common))
    assert ttrain._restore(_args(steps=8, resume=True, **common),
                           fresh.model, None, fresh.tx) == 5
    assert 'fast-forwarded to step 5' in capsys.readouterr().out
    assert fresh.tx.count == 5
    assert all(not m.any() for m in fresh.tx.state()['mu'].values())


def test_trained_checkpoint_serves_from_torch_predictor(tmp_path):
    """A stochastic space-to-depth run's checkpoint: ``TorchPredictor``
    adopts its ``model_config.json``, restores ``view0/params.npz``
    (``restored=True``) to the trained weights, and predicts; the
    posterior and the optimizer state lie beside it."""
    args = _args(steps=2, model_dir=str(tmp_path), std_factor=4,
                 latent_dim=4, stochastic=True, log_every=1)
    _, trainer = ttrain.train(args)
    with open(os.path.join(str(tmp_path), 'model_config.json')) as f:
        assert json.load(f) == ttrain.model_config_dict(args)
    for sub in ('posterior/params.npz', 'opt/' + ttrain.OPT_FILE):
        assert os.path.isfile(os.path.join(str(tmp_path), sub))
    pred = TorchPredictor(str(tmp_path), {'img_dims': (H, W),
                                          'dtype': 'float32'},
                          device='cpu').restore()
    assert pred.restored
    for (n, p), q in zip(trainer.model.state_dict().items(),
                         pred.models[0].state_dict().values()):
        assert torch.equal(p, q), n
    rng = np.random.RandomState(0)
    out = pred({'context_frames': rng.rand(2, 1, H, W, 3),
                'context_actions': rng.randn(1, 3) * 0.1,
                'context_states': rng.randn(2, 3) * 0.1,
                'context_pixel_distributions': np.ones((2, 1, H, W, 1)) /
                (H * W)},
               {'actions': rng.randn(3, 4, 3) * 0.1})
    assert out['predicted_frames'].shape == (3, 4, 1, H, W, 3)
    assert np.isfinite(out['predicted_frames']).all()


# -- the trainer's entry and the tail's gradient guards ---------------------

# --data_dir without manifest.pkl reads HDF5 trajectories: where there are
# none, the RoboNet reader raises as JAX's discover does
@pytest.mark.parametrize('flag,error,match', [
    (dict(data_dir='records'), FileNotFoundError,
     'no hdf5 trajectories under records')], ids=['data_dir'])
def test_unported_flags_raise(flag, error, match):
    with pytest.raises(error, match=match):
        ttrain.train(_args(steps=1, **flag))


def test_n_devices_trains_on_the_cpu():
    """``--n_devices 2 --device cpu`` splits the batch over two entries
    of the CPU and trains (``tests/test_torch_mesh.py`` holds it against
    one device and JAX)."""
    history, trainer = ttrain.train(_args(steps=2, log_every=1, n_devices=2))
    assert trainer.mesh.size == 2 and len(history) == 2
    assert all(np.isfinite(h['loss']) for h in history)


def test_trainer_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    args = _args(steps=1)
    args.device = ttrain.build_argparser().get_default('device')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ttrain.train(args)


LOSS_FALL = 0.8    # chip_smoke.py holds the full-width run to the same


def test_trainer_loss_falls_on_synthetic_batches():
    """Thirty steps of ``train`` on fresh synthetic batches at the
    flagship's geometry (48x64, 15 frames, space-to-depth by 4) and narrow
    widths, batch 8: the mean loss of the last five steps is under 0.8 of
    the first five's (0.66 measured here)."""
    args = ttrain.build_argparser().parse_args(
        ['--device', 'cpu', '--steps', '30', '--batch_size', '8',
         '--log_every', '1', '--std_factor', '4', '--enc_features', '16',
         '32', '32', '--lstm_kernel', '3'])
    history, _ = ttrain.train(args)
    losses = [h['loss'] for h in history]
    assert np.isfinite([h['grad_norm'] for h in history]).all()
    assert np.mean(losses[-5:]) < LOSS_FALL * np.mean(losses[:5]), losses


def _tail_args(p=0):
    gen = torch.Generator().manual_seed(0)
    b, h, w, k, m = 2, 8, 8, 5, 3
    masks = torch.softmax(torch.randn((b, h, w, m + 2), generator=gen), -1)
    kernels = torch.rand((b, k, k, m), generator=gen)
    kernels = kernels / kernels.sum(dim=(1, 2), keepdim=True)
    frames = [torch.rand((b, h, w, c), generator=gen) for c in (3, 3, p, p)]
    return frames + [kernels, masks]


class _Reached(Exception):
    """Raised by the stand-ins of the checks before a launch."""


@pytest.mark.parametrize('entry', ['eff', 'dna', 'folded-with-distribs'])
def test_entries_without_a_backward_raise_under_grad(entry, monkeypatch):
    """On a kernel path (the device check made to say so), the field-given
    entry, the DNA mode, and the folded entry with P > 0 raise when an input
    needs a gradient, before any launch; under ``no_grad`` they go on to
    the launch."""
    monkeypatch.setattr(cdna_tail, '_uses_kernel', lambda t: True)
    launched = []

    def stand_in(name):
        def reached(*args):
            launched.append(name)
            raise _Reached(name)
        return reached
    for name in ('_launch', '_check_eff', '_check_dna'):
        monkeypatch.setattr(cdna_tail, name, stand_in(name))
    args = _tail_args(p=1 if entry == 'folded-with-distribs' else 0)
    if entry == 'eff':
        fn = cdna_tail.fused_warp_composite_eff
        args[4] = torch.rand(2, 8, 8, 25)
        args[5] = args[5][..., :2]
    elif entry == 'dna':
        fn = cdna_tail.fused_warp_composite_dna
        args[4] = torch.rand(2, 8, 8, 25)
    else:
        fn = cdna_tail.fused_warp_composite
    args[4].requires_grad_()
    with pytest.raises(RuntimeError, match='backward'):
        fn(*args)
    assert not launched
    with torch.no_grad(), pytest.raises(_Reached):
        fn(*args)
    assert len(launched) == 1


def test_folded_entry_records_its_backward_on_a_kernel_path(monkeypatch):
    """On a kernel path under grad, the folded entry (P = 0) runs as an
    autograd node: its forward launches once, its backward calls
    ``fused_warp_composite_backward`` once with the gradients asked for
    (``first`` needs none), and the gradients equal autograd of the plain
    version.  The launches are stood in for by the plain versions."""
    monkeypatch.setattr(cdna_tail, '_uses_kernel', lambda t: True)
    calls = []

    def launch(*a):
        calls.append('forward')
        with torch.no_grad():
            return cdna_tail.fused_warp_composite_reference(*a)

    def backward(grad, prev, first, kernels, masks, sna, mask_block, needs):
        calls.append(('backward', needs))
        grads = cdna_tail.fused_warp_composite_backward_reference(
            grad, prev, first, kernels, masks, sna, mask_block)
        return tuple(g if n else None for g, n in zip(grads, needs))

    monkeypatch.setattr(cdna_tail, '_launch', launch)
    monkeypatch.setattr(cdna_tail, 'fused_warp_composite_backward', backward)
    args = _tail_args()
    grads = []
    for fn in (cdna_tail.fused_warp_composite,
               cdna_tail.fused_warp_composite_reference):
        leaves = [t.clone().requires_grad_() for t in
                  (args[0], args[4], args[5])]
        out, _ = fn(leaves[0], args[1], args[2], args[3], leaves[1],
                    leaves[2], True, 0)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum() \
            .backward()
        grads.append([t.grad for t in leaves])
    assert calls == ['forward', ('backward', (True, False, True, True))]
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
