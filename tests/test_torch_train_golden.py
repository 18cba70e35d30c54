"""A golden of three JAX train steps of the vendored flagship, for machines
that have no JAX: ``visual_foresight_torch/weights/xz_flagship/
golden_train_f32.npz``.

JAX's trainer (``make_loss_fn`` and the optax chain ``train`` builds,
composed as its ``make_train_step``) takes three steps from the flagship's
exported parameters with the dtype overridden to f32, at batch 4 and 6
frames (5 model steps), on the first batch of ``synthetic_batches`` with
``seed`` (the batch is made again from the seed, not stored), with the
scheduled-sampling masks (``ss_k`` 2, so they mix ground truth and
predictions) stored and injected.  The golden holds each step's loss, image
and state L2 and global gradient norm, a digest of every leaf's change over
the three updates (its sum and its L2 norm) and two small leaves in full.
Update 0 moves nothing (the schedule starts at 0).  Write it where JAX is
installed::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_golden.py --write

The port replays it here on the CPU and ``chip_smoke.py`` on the card,
through the tail's forward and backward kernels.  Tolerances (f32):
losses rtol 1e-5 and gradient norms rtol 1e-4 (the same sums in another
order through the full-width steps); each leaf's change, its L2 norm rtol
1e-3 and its sum within 1e-3 of sqrt(n) times that norm (a bound of the
change's L1 norm), the two leaves in full within 1e-3 of their largest
change (Adam moves a gradient near the rounding level by a full step on
either side)."""

import argparse
import os

import numpy as np
import pytest
import torch

from test_torch_planner import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT = os.path.join(REPO, 'visual_foresight_torch', 'weights',
                      'xz_flagship')
GOLDEN = os.path.join(EXPORT, 'golden_train_f32.npz')
CONFIG = dict(batch_size=4, sequence_length=6, seed=5, lr=1e-3, steps=3,
              ss_k=2.0)
FULL_LEAVES = ('params/step/state_head/kernel', 'params/step/ln4/ln/bias')
METRICS = ('loss', 'img_l2', 'state_l2', 'grad_norm')
LOSS_RTOL, NORM_RTOL, CHANGE_RTOL = 1e-5, 1e-4, 1e-3


def trainer_args():
    """The flagship's architecture (its ``model_config.json``) in f32, at
    the golden's batch, length and schedule."""
    from visual_foresight_torch.training.train_predictor import (
        build_argparser)
    argv = ['--std_factor', '4', '--enc_features', '128', '256', '256',
            '--lstm_kernel', '3', '--device', 'cpu']
    for key in ('batch_size', 'sequence_length', 'lr', 'steps', 'ss_k'):
        argv += ['--' + key, str(CONFIG[key])]
    return build_argparser().parse_args(argv)


def golden_batch():
    from visual_foresight_torch.training.train_predictor import (
        synthetic_batches)
    return next(synthetic_batches(trainer_args(), seed=CONFIG['seed']))


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def digests(before, after):
    """{leaf: (sum, L2 norm)} of each leaf's change."""
    return {k: (float(np.sum(after[k] - v, dtype=np.float64)),
                float(np.linalg.norm((after[k] - v).ravel())))
            for k, v in before.items()}


def write_golden():
    import jax
    import jax.numpy as jnp
    import optax

    from visual_foresight_tpu.models.cdna import CDNAPredictor
    from visual_foresight_tpu.training import train_predictor as jtrain
    from visual_foresight_torch.models.convert import unflatten_flax
    args = trainer_args()
    model = CDNAPredictor(
        n_context=2, num_masks=10, kernel_size=5, sna=True, num_distribs=0,
        sdim=3, adim=3, lstm_kernel=3, separable_lstm=True, std_factor=4,
        enc_features=(128, 256, 256), dtype=jnp.float32)
    flat = _load(os.path.join(EXPORT, 'view0', 'params.npz'))
    params = jax.tree.map(jnp.asarray, unflatten_flax(flat))
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(200, args.steps // 10 + 1),
        decay_steps=max(args.steps, 2))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(schedule, weight_decay=1e-5))
    step_fn = jax.jit(jtrain.make_train_step(model, tx, 2, ss_k=args.ss_k))
    batch = {k: jnp.asarray(v) for k, v in golden_batch().items()}
    opt_state = tx.init(params)
    out = {k: [] for k in METRICS + ('gt_mask',)}
    for step in range(CONFIG['steps']):
        key = jax.random.PRNGKey(100 + step)
        out['gt_mask'].append(np.asarray(jtrain.scheduled_sampling_mask(
            jax.random.split(key)[0], jnp.asarray(float(step)),
            CONFIG['sequence_length'] - 1, CONFIG['batch_size'], 2,
            k=args.ss_k)))
        params, opt_state, metrics = step_fn(params, opt_state, batch, key,
                                             jnp.asarray(float(step)))
        for k in METRICS:
            out[k].append(float(metrics[k]))
        print('step {}: {}'.format(step, {k: out[k][-1] for k in METRICS}))
    after = {'/'.join(str(p.key) for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    dig = digests(flat, after)
    golden = {k: np.asarray(v, np.float32) for k, v in out.items()}
    golden['digest_leaves'] = np.asarray(sorted(dig))
    golden['digest'] = np.asarray([dig[k] for k in sorted(dig)], np.float64)
    golden['digest_sizes'] = np.asarray([flat[k].size for k in sorted(dig)])
    for leaf in FULL_LEAVES:
        golden['full/' + leaf] = after[leaf]
    golden.update({'config/' + k: np.asarray(v) for k, v in CONFIG.items()})
    np.savez_compressed(GOLDEN, **golden)
    print('wrote {} ({} bytes)'.format(GOLDEN, os.path.getsize(GOLDEN)))


def replay(golden, device='cpu'):
    """The port's three steps on the golden's batch and masks; returns
    ({metric: [3 values]}, {leaf: (sum, norm)}, {leaf: array})."""
    from visual_foresight_torch.models.convert import (flatten_flax,
                                                       load_flax_params,
                                                       params_to_flax,
                                                       unflatten_flax)
    from visual_foresight_torch.training import train_predictor as ttrain
    args = trainer_args()
    model = ttrain.build_model(args)
    before = _load(os.path.join(EXPORT, 'view0', 'params.npz'))
    load_flax_params(model, unflatten_flax(before))
    model.to(device)
    tx = ttrain.ClippedAdamW(ttrain._named_params(model),
                             ttrain.training_schedule(args))
    step_fn = ttrain.make_train_step(model, tx, 2, ss_k=args.ss_k)
    batch = ttrain.to_device(golden_batch(), device)
    got = {k: [] for k in METRICS}
    for step in range(CONFIG['steps']):
        metrics = step_fn(batch, step, gt_mask=torch.as_tensor(
            golden['gt_mask'][step], device=device))
        for k in METRICS:
            got[k].append(float(metrics[k]))
    after = flatten_flax(params_to_flax(model.state_dict()))
    return got, digests(before, after), {k: after[k] for k in FULL_LEAVES}


def check_replay(golden, got, dig, full):
    """Raise AssertionError where the replay leaves the golden's
    tolerances; return the largest errors by kind, each relative to what
    its tolerance scales with."""
    worst = dict.fromkeys(('loss', 'grad_norm', 'change_norm', 'change_sum',
                           'full'), 0.0)
    for k in METRICS:
        kind, rtol = ('grad_norm', NORM_RTOL) if k == 'grad_norm' else \
            ('loss', LOSS_RTOL)
        for g, w in zip(got[k], golden[k]):
            err = abs(g - float(w)) / abs(float(w))
            worst[kind] = max(worst[kind], err)
            assert err <= rtol, (k, g, float(w))
    for leaf, (wsum, wnorm), size in zip(golden['digest_leaves'],
                                         golden['digest'],
                                         golden['digest_sizes']):
        gsum, gnorm = dig[str(leaf)]
        norm_err = abs(gnorm - wnorm) / wnorm
        sum_err = abs(gsum - wsum) / (np.sqrt(size) * wnorm)
        worst['change_norm'] = max(worst['change_norm'], norm_err)
        worst['change_sum'] = max(worst['change_sum'], sum_err)
        assert norm_err <= CHANGE_RTOL and sum_err <= CHANGE_RTOL, \
            (str(leaf), gsum, wsum, gnorm, wnorm)
    before = _load(os.path.join(EXPORT, 'view0', 'params.npz'))
    for leaf in FULL_LEAVES:
        want = golden['full/' + leaf]
        change = float(np.abs(want - before[leaf]).max())
        err = float(np.abs(full[leaf] - want).max()) / change
        worst['full'] = max(worst['full'], err)
        assert err <= CHANGE_RTOL, (leaf, err)
    return worst


@pytest.fixture(scope='module')
def golden():
    return _load(GOLDEN)


def test_golden_stays_small_and_names_its_config(golden):
    assert os.path.getsize(GOLDEN) < 1 << 20
    assert {k: golden['config/' + k].item() for k in CONFIG} == CONFIG
    assert golden['gt_mask'].shape == (CONFIG['steps'], CONFIG['batch_size'],
                                       CONFIG['sequence_length'] - 1)
    # the masks mix ground truth and predictions past the context step
    assert 0 < golden['gt_mask'][:, :, 2:].mean() < 1
    assert golden['digest'].shape == (len(golden['digest_leaves']), 2)


def test_port_replays_golden_train_steps_on_cpu(golden):
    got, dig, full = replay(golden)
    check_replay(golden, got, dig, full)


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--write', action='store_true',
                    help='write the golden train steps')
    if ap.parse_args().write:
        import jax
        jax.config.update('jax_platforms', 'cpu')
        write_golden()
