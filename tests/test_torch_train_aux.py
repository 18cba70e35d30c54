"""Port parity: the trainers of the planning costs' networks
(``training/train_gdn.py``, ``train_classifier.py`` in both modes and both
label modes, ``train_inverse.py``) against the JAX package's, and the
predictor trainer's ``--data_dir`` path.

- Every batch maker against JAX's: the same numpy draws from the same seed,
  on synthetic data and on a shard, bit for bit.
- Four f32 Adam steps of each trainer from JAX's initial weights (its
  ``init``, injected through the converter), on synthetic batches and on
  batches read from a shard written by the port: the loss (and the
  photometric loss, ``zero_mse``) within rtol 1e-4 of JAX's at every step;
  each leaf's change over the four steps by its L2 norm (relative) and its
  sum (over sqrt(size) times the norm) within 1e-3 of JAX's.  Element by
  element the changes are not compared: on a gradient near zero, Adam's
  first step is about ``lr * sign(g)``, so float noise can move a single
  element by up to twice the rate.
- ``record_batches`` equals JAX's (``--loader python``) bit for bit;
  ``train_predictor --data_dir`` trains at tiny widths on the CPU through
  either loader; a directory without ``manifest.pkl`` goes to the RoboNet
  reader, which raises ``FileNotFoundError`` where it finds no HDF5
  trajectory, as JAX's does.
- A port-trained ``params.npz`` restores through ``restore_network`` (the
  same outputs exactly) and, through ``params_to_flax`` and the file alike,
  into the JAX network with outputs equal within atol 1e-5.

Frames are 16 x 24, trajectories of 6 frames, batches of 4."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.agent.utils.traj_saver import GeneralAgentSaver
from visual_foresight_torch.models import classifier as tclf
from visual_foresight_torch.models import gdn as tgdn
from visual_foresight_torch.models import inverse as tinv
from visual_foresight_torch.models.convert import (flatten_flax,
                                                   params_to_flax, read_npz,
                                                   restore_network,
                                                   unflatten_flax)
from visual_foresight_torch.training import train_classifier as tc
from visual_foresight_torch.training import train_gdn as tg
from visual_foresight_torch.training import train_inverse as ti
from visual_foresight_torch.training import train_predictor as tp
from visual_foresight_tpu.models import classifier as jclf
from visual_foresight_tpu.models import gdn as jgdn
from visual_foresight_tpu.models import inverse as jinv
from visual_foresight_tpu.training import train_classifier as jc
from visual_foresight_tpu.training import train_gdn as jg
from visual_foresight_tpu.training import train_inverse as ji
from visual_foresight_tpu.training import train_predictor as jp

H, W, T, N_TRAJ, ADIM, SDIM = 16, 24, 6, 8, 3, 3
STEPS = 4
LOSS_RTOL = 1e-4
LEAF_TOL = 1e-3
OUT_ATOL = 1e-5
METRICS = ('loss', 'photometric', 'zero_mse')


@pytest.fixture(scope='module')
def shard(tmp_path_factory):
    """Eight trajectories of smooth moving blobs (so that frames differ
    and no goal-conditioned negative is ambiguous) in two shards."""
    directory = str(tmp_path_factory.mktemp('records'))
    saver = GeneralAgentSaver(directory, T, traj_per_file=4,
                              split=(1.0, 0.0, 0.0))
    rr, cc = np.mgrid[:H, :W]
    for i in range(N_TRAJ):
        rng = np.random.RandomState(i)
        r, c = rng.uniform(2, H - 2), rng.uniform(2, W - 2)
        dr, dc = rng.uniform(-1.5, 1.5, 2)
        color = rng.uniform(0.3, 1.0, 3)
        frames = []
        for t in range(T):
            blob = np.exp(-((rr - r - t * dr) ** 2 + (cc - c - t * dc) ** 2)
                          / 8.0)
            frames.append(np.round(255 * (0.1 + 0.8 * blob[..., None] *
                                          color)).astype(np.uint8))
        obs = {'images': np.stack(frames)[:, None],
               'state': rng.randn(T, SDIM).astype(np.float32)}
        policy_out = [{'actions': rng.uniform(-1, 1, ADIM).astype(
            np.float32)} for _ in range(T)]
        saver.save_traj({'goal_reached': bool(i % 2)}, obs, policy_out)
    saver.flush()
    return directory


def _args(data_dir='', **kw):
    base = dict(data_dir=data_dir, model_dir='', steps=STEPS, batch_size=4,
                lr=1e-3, image_height=H, image_width=W, camera=0, seed=0,
                log_every=1, device='cpu', max_dt=2, smooth_weight=0.01,
                label_mode='goal', ambiguous_pixel_diff=0.01, adim=ADIM,
                plan_T=2, num_context=2, ckpt_every=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


# (JAX trainer, port trainer, JAX init, extra args) by case
def _init_gdn(a, key, z):
    return jgdn.GoalDistanceNet().init(key, z, z)


def _init_clf(a, key, z):
    return jclf.SuccessClassifier().init(key, z, z)


def _init_nce(a, key, z):
    return jclf.NCEEmbedding().init(key, z)


def _init_inv(a, key, z):
    return jinv.InverseNet(a.adim, a.plan_T).init(
        key, z, z, jnp.zeros((1, a.num_context, H, W, 3)))


CASES = {
    'gdn': (jg.train, tg.train, _init_gdn, {}),
    'classifier_goal': (jc.train_classifier, tc.train_classifier, _init_clf,
                        {}),
    'classifier_lift': (jc.train_classifier, tc.train_classifier, _init_clf,
                        {'label_mode': 'lift'}),
    'nce': (jc.train_nce, tc.train_nce, _init_nce, {}),
    'inverse': (ji.train_inverse, ti.train_inverse, _init_inv, {}),
}
# the synthetic inverse task draws its square at least 8 pixels from the
# edges of a frame of 25 or more
SYNTHETIC_INVERSE = {'image_height': 32, 'image_width': 32}

_RUNS = {}


def _run(case, data, shard):
    """``STEPS`` steps of JAX's trainer and of the port's from JAX's
    initial weights; cached.  Returns (JAX history, port history, initial
    flat leaves, JAX's final flat leaves, the port's)."""
    if (case, data) in _RUNS:
        return _RUNS[case, data]
    jtrain, ttrain, init_fn, extra = CASES[case]
    if data == 'synthetic' and case == 'inverse':
        extra = SYNTHETIC_INVERSE
    args = _args(shard if data == 'shard' else '', **extra)
    init = jax.tree.map(np.asarray, init_fn(
        args, jax.random.PRNGKey(args.seed), jnp.zeros((1, H, W, 3))))
    jhist, jparams = jtrain(args)
    thist, model = ttrain(args, init=init)
    _RUNS[case, data] = (jhist, thist, flatten_flax(init),
                         flatten_flax(jax.tree.map(np.asarray, jparams)),
                         flatten_flax(params_to_flax(model.state_dict())))
    return _RUNS[case, data]


@pytest.mark.parametrize('data', ['synthetic', 'shard'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_losses_match_jax_each_step(case, data, shard):
    jhist, thist, _, _, _ = _run(case, data, shard)
    assert [h['step'] for h in thist] == list(range(STEPS))
    for j, t in zip(jhist, thist):
        for k in METRICS:
            if k in j:
                np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL,
                                           err_msg='{} step {}'.format(
                                               k, j['step']))
    assert len(jhist) == len(thist) == STEPS


@pytest.mark.parametrize('data', ['synthetic', 'shard'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_leaf_changes_match_jax(case, data, shard):
    _, _, before, jafter, tafter = _run(case, data, shard)
    assert set(before) == set(jafter) == set(tafter)
    for k in before:
        cj = jafter[k].astype(np.float64) - before[k]
        ct = tafter[k].astype(np.float64) - before[k]
        norm = np.linalg.norm(cj)
        assert norm > 0, k
        assert abs(np.linalg.norm(ct) - norm) <= LEAF_TOL * norm, k
        assert abs(ct.sum() - cj.sum()) <= \
            LEAF_TOL * np.sqrt(cj.size) * norm, k


# -- the batch makers -------------------------------------------------------------

MAKERS = {
    'synthetic_pairs': (tg.synthetic_pairs, jg.synthetic_pairs, False),
    'frame_pair_batches': (tg.frame_pair_batches, jg.frame_pair_batches,
                           True),
    'synthetic_goal_batches': (tc.synthetic_goal_batches,
                               jc.synthetic_goal_batches, False),
    'synthetic_classifier_batches': (tc.synthetic_classifier_batches,
                                     jc.synthetic_classifier_batches, False),
    'goal_conditioned_batches': (tc.goal_conditioned_batches,
                                 jc.goal_conditioned_batches, True),
    'classifier_batches': (tc.classifier_batches, jc.classifier_batches,
                           True),
    'synthetic_window_batches': (ti.synthetic_window_batches,
                                 ji.synthetic_window_batches, False),
    'window_batches': (ti.window_batches, ji.window_batches, True),
}


@pytest.mark.parametrize('maker', sorted(MAKERS))
def test_batch_makers_match_jax_bit_for_bit(maker, shard):
    port, jax_, records = MAKERS[maker]
    extra = SYNTHETIC_INVERSE if maker == 'synthetic_window_batches' else {}
    args = _args(shard if records else '', seed=3, **extra)
    got, want = port(args), jax_(args)
    for _ in range(3):
        g, w = next(got), next(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_goal_conditioned_batches_weigh_ambiguous_negatives_zero(shard):
    # a gap no pair reaches: every negative is ambiguous
    args = _args(shard, ambiguous_pixel_diff=2.0)
    for _ in range(3):
        _, _, labels, weights = next(tc.goal_conditioned_batches(args))
        np.testing.assert_array_equal(weights, labels)


def test_window_batches_refuse_short_trajectories(shard):
    with pytest.raises(ValueError, match='too short'):
        next(ti.window_batches(_args(shard, plan_T=T - 1)))


# -- the predictor trainer from records ----------------------------------------

def _predictor_argv(shard, *extra):
    return ['--data_dir', shard, '--batch_size', '2', '--sequence_length',
            str(T), '--image_height', str(H), '--image_width', str(W),
            '--num_masks', '2', '--enc_features', '8', '16', '16',
            '--lstm_kernel', '3', '--seed', '0', *extra]


def test_record_batches_equal_jax_bit_for_bit(shard):
    argv = _predictor_argv(shard, '--loader', 'python')
    got = tp.record_batches(tp.build_argparser().parse_args(
        argv + ['--device', 'cpu']))
    want = jp.record_batches(jp.build_argparser().parse_args(argv))
    for _ in range(3):
        g, w = next(got), next(want)
        assert set(g) == set(w) == {'images', 'actions', 'states'}
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
    assert g['images'].dtype == np.uint8 and \
        g['images'].shape == (2, T, H, W, 3)


@pytest.mark.parametrize('loader', ['python', 'fused'])
def test_predictor_trains_from_records(shard, tmp_path, loader):
    args = tp.build_argparser().parse_args(_predictor_argv(
        shard, '--loader', loader, '--device', 'cpu', '--steps', '3',
        '--log_every', '1', '--model_dir', str(tmp_path)))
    history, trainer = tp.train(args)
    assert len(history) == 3
    assert all(np.isfinite(list(h.values())).all() for h in history)
    assert os.path.isfile(tmp_path / 'view0' / 'params.npz')
    assert trainer.device.type == 'cpu'


def test_data_dir_without_manifest_names_the_robonet_item(tmp_path):
    """A directory without ``manifest.pkl`` goes to the RoboNet reader,
    which raises on one that holds no HDF5 trajectories, as JAX's does."""
    args = tp.build_argparser().parse_args(_predictor_argv(
        str(tmp_path), '--device', 'cpu', '--steps', '1'))
    match = 'no hdf5 trajectories under {}'.format(tmp_path)
    with pytest.raises(FileNotFoundError, match=match):
        tp.train(args)
    with pytest.raises(FileNotFoundError, match=match):
        next(jp.record_batches(args))


# -- a trained network served ---------------------------------------------------------

def _nets():
    """(port module, JAX apply, inputs) of each network."""
    rng = np.random.RandomState(5)
    frames = lambda *s: rng.rand(*s, H, W, 3).astype(np.float32)
    cur, goal, ctx = frames(3), frames(3), frames(3, 2)
    return {
        'gdn': (tg, tgdn.GoalDistanceNet, jgdn.GoalDistanceNet(),
                (cur, goal)),
        'classifier': (tc, tclf.SuccessClassifier, jclf.SuccessClassifier(),
                       (cur, goal)),
        'nce': (tc, tclf.NCEEmbedding, jclf.NCEEmbedding(), (cur,)),
        'inverse': (ti, lambda: tinv.InverseNet(ADIM, 2, 2),
                    jinv.InverseNet(ADIM, 2), (cur, goal, ctx)),
    }


def _outputs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.detach() if torch.is_tensor(o) else o)
            for o in outs]


@pytest.mark.parametrize('net', ['gdn', 'classifier', 'nce', 'inverse'])
def test_trained_params_restore_in_both_packages(net, tmp_path):
    trainer, make, jmodel, inputs = _nets()[net]
    args = _args(model_dir=str(tmp_path), steps=2,
                 **(SYNTHETIC_INVERSE if net == 'inverse' else {}))
    train = {'gdn': tg.train, 'classifier': tc.train_classifier,
             'nce': tc.train_nce, 'inverse': ti.train_inverse}[net]
    _, model = train(args)
    with open(tmp_path / 'net_config.json') as f:
        config = json.load(f)
    seeded = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(tp.__file__))), 'weights', 'seeded_' + net,
        'net_config.json')
    with open(seeded) as f:
        assert set(config) == set(json.load(f))
    model.eval()
    restored = make().eval()
    assert restore_network(restored, str(tmp_path))
    x = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        want = _outputs(model(*x))
        for a, b in zip(_outputs(restored(*x)), want):
            np.testing.assert_array_equal(a, b)
    trees = (params_to_flax(model.state_dict()),
             unflatten_flax(read_npz(str(tmp_path / 'params.npz'))))
    for tree in trees:
        got = _outputs(jmodel.apply(jax.tree.map(jnp.asarray, tree),
                                    *map(jnp.asarray, inputs)))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=OUT_ATOL)
