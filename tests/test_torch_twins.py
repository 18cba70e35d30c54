"""Every campaign twin of the port against the JAX config it copies.

- Each twin's config tree equals its source's (loaded by the JAX package's
  ``sim/run.py::load_config``) with every ``VMPC_*`` variable the source
  reads set to the same value on both sides: classes mapped by module path
  (``visual_foresight_tpu.`` to ``visual_foresight_torch.``,
  ``TPUPredictor`` to ``TorchPredictor``), numbers and arrays exact.  The
  only differences allowed are the source's experiment directory
  (``current_dir`` and what the source builds from it, which the twin puts
  under ``campaigns/runs/<twin>/``) and, with the variables unset, the
  default weights (``TWINS``): each then a vendored export under
  ``weights/`` or a stand-in under ``build/stand_ins/``.  A twin reads the
  same ``VMPC_*`` names as its source.
- Each twin's policy builds on the CPU (tiny predictor widths, missing
  weights) beside the JAX one (a CEM controller up to its hparams), with
  the same hparams; where the JAX policy raises on an override equal to
  its default, the twin's raises the same ``ValueError``, and with those
  keys dropped both build.
- Loading every twin imports neither JAX nor the JAX package (a
  subprocess, as ``test_torch_isolation.py`` does).
- ``stand_ins.py`` writes the views that ``chip_smoke.py`` and
  ``test_torch_weights_aux.py`` serve, byte for byte the noisy copies that
  the goldens were made with, and warns.
"""

import contextlib
import glob
import io
import json
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.campaigns import stand_ins
from visual_foresight_torch.policy.cem_controllers.cem_base_controller import (
    CEMBaseController)
from visual_foresight_torch.policy.inverse_models.inverse_model_base_controller import (  # noqa: E501
    InvModelBaseController)
from visual_foresight_torch.sim import run as t_run
from visual_foresight_tpu.policy.cem_controllers.cem_base_controller import (
    CEMBaseController as JaxCEMBaseController)
from visual_foresight_tpu.sim import run as j_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGNS = os.path.join(REPO, 'visual_foresight_torch', 'campaigns')
RUNS = os.path.join(CAMPAIGNS, 'runs')
WEIGHTS = os.path.join(REPO, 'visual_foresight_torch', 'weights')

MODEL = ('policy', 'model_path')
# twin -> (source, (adim, sdim, ncam) of its env, the paths of the default
# weights, where the twin departs from its source on purpose, as its
# docstring says: key paths, and VMPC_* variables of its own)
XZ, AG = (3, 3, 1), (4, 5, 1)
DATA = ('agent', 'data_save_dir')
# the sawyer collection sources leave their output to be overridden
SAWYER = [('current_dir',), DATA, 'VMPC_DATA_DIR']
TWINS = {
    # the twins of earlier slices
    'xz_bench20': ('benchmarks/xz_bench20/hparams.py', XZ, [MODEL], []),
    'ag_bench20': ('benchmarks/ag_bench20/hparams.py', AG, [MODEL], []),
    'collect_xz_r4': ('data_collection/sim/cartgripper_xz_grasp/'
                      'r4_flagship/hparams.py', XZ, [], [DATA]),
    'collect_sawyer_arm': ('data_collection/sim/sawyer_arm/hparams.py',
                           (5, 5, 1), [], SAWYER),
    'collect_sawyer_grasp': ('data_collection/sim/sawyer_grasp/hparams.py',
                             (4, 5, 1), [], SAWYER),
    'offline_towel_classifier': (
        'experiments/offline_exp/towel_classifier/hparams.py', AG,
        [MODEL, ('policy', 'classifier_path')],
        [('agent', 'env', 1, 'data_dir'), ('agent', 'env', 1, 'adim'),
         ('agent', 'env', 1, 'sdim'), ('policy', 'state_append'), DATA,
         ('end_index',), 'VMPC_DATA_DIR', 'VMPC_END_INDEX', 'VMPC_REPLAY_DIR']),
    'robot_sawyer_pixel_cost': ('experiments/sawyer/pixel_cost/hparams.py',
                                (4, 5, 2), [], []),
    # the benchmarks
    'ag_bench20_hard': ('benchmarks/ag_bench20_hard/hparams.py', AG,
                        [MODEL], []),
    'ag_bench20_classifier': ('benchmarks/ag_bench20_classifier/hparams.py',
                              AG, [MODEL, ('policy', 'classifier_path')],
                              []),
    'ag_bench20_ensemble': ('benchmarks/ag_bench20_ensemble/hparams.py', AG,
                            [MODEL + (0,), MODEL + (1,)], []),
    'xz_bench20_ensemble': ('benchmarks/xz_bench20_ensemble/hparams.py', XZ,
                            [MODEL + (i,) for i in range(3)], []),
    'xz2c_bench20_registration': (
        'benchmarks/xz2c_bench20_registration/hparams.py', (3, 3, 2),
        [MODEL, ('policy', 'gdn_path')], []),
    'xz_bench20_nce': ('benchmarks/xz_bench20_nce/hparams.py', XZ,
                       [MODEL, ('policy', 'embedding_path')], []),
    'xz_bench20_inverse': ('benchmarks/xz_bench20_inverse/hparams.py', XZ,
                           [('policy', 'model_params_path')], []),
    'ag_bench20_inverse': ('benchmarks/ag_bench20_inverse/hparams.py', AG,
                           [('policy', 'model_params_path')], []),
    'xz_bench20_random': ('benchmarks/xz_bench20_random/hparams.py', XZ, [],
                          []),
    'xz2c_bench20_random': ('benchmarks/xz2c_bench20_random/hparams.py',
                            (3, 3, 2), [], []),
    'ag_bench20_random': ('benchmarks/ag_bench20_random/hparams.py', AG, [],
                          []),
    # experiments/sim
    'sim_autograsp_stochastic': (
        'experiments/sim/autograsp_stochastic/hparams.py', AG, [MODEL], []),
    'sim_two_cam_registration': (
        'experiments/sim/two_cam_registration/hparams.py', (3, 3, 2),
        [MODEL, ('policy', 'gdn_path')], []),
    'sim_2d_grasping_pixel_cost': (
        'experiments/sim/cartgripper_2d_grasping/pixel_cost/hparams.py', XZ,
        [MODEL], []),
    'sim_2d_grasping_nce_experiments': (
        'experiments/sim/cartgripper_2d_grasping/nce_experiments/hparams.py',
        XZ, [MODEL, ('policy', 'embedding_path')], []),
    'sim_2d_grasping_create_configs': (
        'experiments/sim/cartgripper_2d_grasping/create_configs/hparams.py',
        XZ, [], []),
    'sim_2d_grasping_generate_tasks': (
        'experiments/sim/cartgripper_2d_grasping/generate_tasks/hparams.py',
        XZ, [], []),
    'sim_ensemble_grasping': ('experiments/sim/ensemble_grasping/hparams.py',
                              AG, [MODEL], []),
    'sim_ensemble_grasping_tasks': (
        'experiments/sim/ensemble_grasping/generate_tasks.py', AG, [], []),
}
# the sources whose policy raises as written: each override equal to its
# default (Policy._override_defaults raises on the first in the dict)
RAISES = {'sim_autograsp_stochastic': ('repeat', 'iterations'),
          'sim_two_cam_registration': ('register_gtruth', 'num_samples',
                                       'repeat', 'iterations'),
          'sim_2d_grasping_pixel_cost': ('repeat',),
          'sim_ensemble_grasping': ('verbose',),
          # an earlier slice's twin of a collection source
          'collect_sawyer_arm': ('nactions',)}
# the twin builds where its source does not, as its docstring says
JAX_ONLY_RAISES = {'offline_towel_classifier': KeyError}
# a value for each VMPC_* variable the sources read
NUMERIC_ENV = {'VMPC_REPLAN': '5', 'VMPC_STD_LIFT': '0.3',
               'VMPC_STOCH_K': '2', 'VMPC_STOCH_PEN': '1.5',
               'VMPC_NUM_SAMPLES': '800', 'VMPC_SAMPLE_CHUNK': '200',
               'VMPC_START_INDEX': '2', 'VMPC_END_INDEX': '7',
               'VMPC_TASK_SET': 'ag_bench20_hard'}
TINY_PREDICTOR = {'std_factor': 4, 'num_masks': 2, 'enc_features': (8, 8, 8)}


def _env_names(path):
    with open(path) as f:
        return set(re.findall(r'VMPC_[A-Z_]+', f.read())) - {'VMPC_'}


def _env_values(names):
    return {n: NUMERIC_ENV.get(n, '/vmpc/' + n[5:].lower()) for n in names}


@contextlib.contextmanager
def _environ(values):
    """``os.environ`` with exactly the ``VMPC_*`` variables of ``values``."""
    saved = {k: v for k, v in os.environ.items() if k.startswith('VMPC_')}
    for k in saved:
        del os.environ[k]
    os.environ.update(values)
    try:
        yield
    finally:
        for k in values:
            del os.environ[k]
        os.environ.update(saved)


def _load_pair(name, values, table=None):
    source = os.path.join(REPO, (table or TWINS)[name][0])
    with _environ(values), warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return (j_run.load_config(source),
                t_run.load_config(os.path.join(CAMPAIGNS, name + '.py')))


def _mapped(cls):
    """(module, name) of a JAX class under the port's naming."""
    module = cls.__module__.replace('visual_foresight_tpu',
                                    'visual_foresight_torch', 1)
    name = {'TPUPredictor': 'TorchPredictor'}.get(cls.__qualname__,
                                                   cls.__qualname__)
    return module, name


def _diff(j, t, path=()):
    """Key paths where the port's tree ``t`` differs from the JAX tree
    ``j`` under the class mapping."""
    if isinstance(j, type):
        ok = isinstance(t, type) and _mapped(j) == (t.__module__,
                                                     t.__qualname__)
        return [] if ok else [path]
    if isinstance(j, dict):
        if not isinstance(t, dict):
            return [path]
        out = [path + (k,) for k in set(j) ^ set(t)]
        for k in set(j) & set(t):
            out += _diff(j[k], t[k], path + (k,))
        return out
    if isinstance(j, (list, tuple)):
        if type(j) is not type(t) or len(j) != len(t):
            return [path]
        return [p for i, (a, b) in enumerate(zip(j, t))
                for p in _diff(a, b, path + (i,))]
    if isinstance(j, np.ndarray):
        ok = isinstance(t, np.ndarray) and j.dtype == t.dtype and \
            np.array_equal(j, t)
        return [] if ok else [path]
    if hasattr(j, '__dict__') and not isinstance(j, (str, bytes)):
        if _mapped(type(j)) != (type(t).__module__, type(t).__qualname__):
            return [path]
        return _diff(vars(j), vars(t), path)
    same = type(j) is type(t) and (j == t or (j != j and t != t))
    return [] if same else [path]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _source_dir(name, table=None):
    return os.path.dirname(os.path.join(REPO, (table or TWINS)[name][0]))


def _experiment_dir_paths(name, jax_cfg, twin_cfg, diffs, table=None):
    """The differences of ``diffs`` that are the experiment directory: a
    string under the source's directory on the JAX side, the same under
    ``runs/<twin>`` on the port's."""
    src, own = _source_dir(name, table), os.path.join(RUNS, name)
    out = []
    for p in diffs:
        j, t = _at(jax_cfg, p), _at(twin_cfg, p)
        if isinstance(j, str) and isinstance(t, str) and \
                j.startswith(src) and t.startswith(own) and \
                j[len(src):] == t[len(own):]:
            out.append(p)
    return out


def check_twin_tree(name, table):
    """The twin's tree against its source's (the module docstring), with
    every ``VMPC_*`` variable set and with none."""
    source, _, defaults, departs = table[name]
    names = _env_names(os.path.join(REPO, source))
    own = {d for d in departs if isinstance(d, str)}
    assert _env_names(os.path.join(CAMPAIGNS, name + '.py')) == names | own
    names |= own
    departs = {d for d in departs if not isinstance(d, str)}
    # every variable set: only the experiment directory differs
    jax_cfg, twin_cfg = _load_pair(name, _env_values(names), table)
    diffs = set(_diff(jax_cfg, twin_cfg))
    assert ('current_dir',) in diffs or name == 'ag_bench20_random'
    diffs -= departs
    assert diffs - set(_experiment_dir_paths(name, jax_cfg, twin_cfg, diffs,
                                             table)) == set(), name
    # none set: the default weights differ too, each a vendored export or
    # a stand-in
    jax_cfg, twin_cfg = _load_pair(name, {}, table)
    diffs = set(_diff(jax_cfg, twin_cfg)) - departs
    rest = diffs - set(_experiment_dir_paths(name, jax_cfg, twin_cfg, diffs,
                                             table))
    assert rest == set(defaults), name
    for p in defaults:
        path = _at(twin_cfg, p)
        assert path.startswith((WEIGHTS, stand_ins.ROOT)), (p, path)
        assert os.path.isdir(path), path


@pytest.mark.parametrize('name', sorted(TWINS))
def test_twin_tree_equals_its_source(name):
    check_twin_tree(name, TWINS)


def _agent(config, dims):
    adim, sdim, ncam = dims
    return dict(config['agent'], adim=adim, sdim=sdim, ncam=ncam)


def _cut_policy(policy, root):
    """A policy on missing weights at tiny predictor widths: each member
    directory of an ensemble holds only a ``model_config.json`` of those
    widths."""
    policy = dict(policy)
    for key in ('model_path', 'gdn_path', 'classifier_path',
                'embedding_path', 'model_params_path',
                'model_restore_path'):
        if isinstance(policy.get(key), list):
            policy[key] = [os.path.join(root, 'm{}'.format(i))
                           for i in range(len(policy[key]))]
            for path in policy[key]:
                os.makedirs(path, exist_ok=True)
                with open(os.path.join(path, 'model_config.json'), 'w') as f:
                    json.dump(TINY_PREDICTOR, f)
        elif key in policy:
            policy[key] = os.path.join(root, key)
    if 'model_path' in policy:
        policy['predictor_hparams'] = dict(policy.get('predictor_hparams',
                                                      {}), **TINY_PREDICTOR)
    return policy


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()), \
            warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return fn()


def _build_port(config, dims, root):
    """The port's policy, built whole on the CPU."""
    policy = _cut_policy(config['policy'], root)
    if issubclass(policy['type'], (CEMBaseController,
                                   InvModelBaseController)):
        policy['device'] = 'cpu'
    return _quiet(lambda: policy['type'](_agent(config, dims), policy))


def _build_jax(config, dims, root):
    """The JAX policy: a CEM controller up to its hparams (the
    ``_default_hparams`` and ``_override_defaults`` that its constructor
    starts with; the networks' JAX init is what the parity tests of the
    controllers cover), any other policy whole."""
    policy = _cut_policy(config['policy'], root)
    cls = policy['type']
    if issubclass(cls, JaxCEMBaseController):
        ctrl = cls.__new__(cls)
        ctrl._hp = ctrl._default_hparams()
        _quiet(lambda: ctrl._override_defaults(policy))
        return ctrl
    return _quiet(lambda: cls(_agent(config, dims), policy))


def check_twin_policy(name, table, root, raises=(), key_raises=(),
                      jax_only_raises=None, fused_raises=None):
    """The twin's policy built on the CPU beside the JAX one (the module
    docstring).  ``raises``: the keys equal to their defaults, on which
    both raise ``ValueError`` in turn; ``key_raises``: keys that neither
    controller declares, on which both raise ``KeyError``;
    ``fused_raises``: a message that the port's fused planner raises
    ``ValueError`` with as written (the JAX package asserts), both
    building with ``use_fused_planner`` off; ``jax_only_raises``: the
    error the JAX policy raises where the twin builds."""
    jax_cfg, twin_cfg = _load_pair(name, {}, table)
    dims = table[name][1]
    for key in raises:
        # each package raises on the same key; dropped, the next raises
        with pytest.raises(ValueError) as j_err:
            _build_jax(jax_cfg, dims, root)
        with pytest.raises(ValueError) as t_err:
            _build_port(twin_cfg, dims, root)
        assert str(j_err.value) == str(t_err.value) == (
            'Policy param {} override is identical to its default!'.format(
                key))
        del jax_cfg['policy'][key], twin_cfg['policy'][key]
    for key in key_raises:
        with pytest.raises(KeyError, match=key):
            _build_jax(jax_cfg, dims, root)
        with pytest.raises(KeyError, match=key):
            _build_port(twin_cfg, dims, root)
        del jax_cfg['policy'][key], twin_cfg['policy'][key]
    if fused_raises:
        with pytest.raises(ValueError, match=fused_raises):
            _build_port(twin_cfg, dims, root)
        policy = _cut_policy(jax_cfg['policy'], root)
        with pytest.raises(AssertionError, match=fused_raises):
            _quiet(lambda: policy['type'](_agent(jax_cfg, dims), policy))
        for cfg in (jax_cfg, twin_cfg):
            cfg['policy']['use_fused_planner'] = False
    t_pol = _build_port(twin_cfg, dims, root)
    if jax_only_raises:
        with pytest.raises(jax_only_raises):
            _build_jax(jax_cfg, dims, root)
        return t_pol
    j_pol = _build_jax(jax_cfg, dims, root)
    skip = {'type', 'predictor_hparams', 'model_path', 'gdn_path',
            'classifier_path', 'embedding_path', 'model_params_path',
            'model_restore_path'}
    if hasattr(j_pol, '_hp'):
        for key in set(twin_cfg['policy']) - skip:
            j_val, t_val = getattr(j_pol._hp, key), getattr(t_pol._hp, key)
            assert _diff(j_val, t_val) == [], (key, j_val, t_val)
    if isinstance(t_pol, (CEMBaseController, InvModelBaseController)):
        assert t_pol.predictor.device.type == 'cpu'
    return t_pol


@pytest.mark.parametrize('name', sorted(TWINS))
def test_twin_policy_builds_as_jax_does(name, tmp_path):
    check_twin_policy(name, TWINS, str(tmp_path), raises=RAISES.get(name, ()),
                      jax_only_raises=JAX_ONLY_RAISES.get(name))


_IMPORTS = r'''
import glob, os, sys, warnings
from visual_foresight_torch.sim.run import load_config
warnings.simplefilter('ignore')
twins = sorted(p for p in glob.glob(os.path.join(sys.argv[1], '*.py'))
               if not p.endswith(('__init__.py', 'stand_ins.py')))
for path in twins:
    load_config(path)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax',
                                            'visual_foresight_tpu')))
print(len(twins), bad)
sys.exit(1 if bad else 0)
'''


def test_twins_import_no_jax():
    env = {k: v for k, v in os.environ.items()
           if k != 'PYTHONPATH' and not k.startswith('VMPC_')}
    proc = subprocess.run([sys.executable, '-c', _IMPORTS, CAMPAIGNS],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # every twin table: this module's, the robot and RoboNet experiments'
    # and the collection configs'
    from test_torch_twins_collect import COLLECT_TWINS
    from test_torch_twins_robot import ROBOT_TWINS
    tables = (TWINS, ROBOT_TWINS, COLLECT_TWINS)
    assert not set(TWINS) & set(ROBOT_TWINS) | \
        set(TWINS) & set(COLLECT_TWINS) | set(ROBOT_TWINS) & set(COLLECT_TWINS)
    assert proc.stdout.split()[0] == str(sum(len(t) for t in tables))
    for path in glob.glob(os.path.join(CAMPAIGNS, '*.py')):
        with open(path) as f:
            text = f.read()
        assert not re.search(r'^\s*(from|import)\s+(jax|flax|'
                             r'visual_foresight_tpu)', text, re.M), path


def test_stand_ins_are_the_golden_copies():
    """The noisy copies are ``perturbed_flat`` of the export under the
    goldens' seeds and scale, written once; each call warns."""
    from visual_foresight_torch.models.convert import (perturbed_flat,
                                                       read_npz)
    flagship = read_npz(os.path.join(WEIGHTS, 'xz_flagship', 'view0',
                                     'params.npz'))
    with pytest.warns(UserWarning, match='xz_ens2'):
        member = stand_ins.noisy_copy('xz_flagship', 71, 'xz_ens2')
    with pytest.warns(UserWarning, match='xz2c_reg'):
        two = stand_ins.second_view('xz_flagship', 73, 'xz2c_reg')
    for path, seed in ((os.path.join(member, 'view0'), 71),
                       (os.path.join(two, 'view1'), 73)):
        got = read_npz(os.path.join(path, 'params.npz'))
        want = perturbed_flat(flagship, seed, stand_ins.COPY_SCALE)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    assert all(np.array_equal(v, flagship[k]) for k, v in read_npz(
        os.path.join(two, 'view0', 'params.npz')).items())
    with pytest.warns(UserWarning, match='ag_r5_inverse'):
        inverse = stand_ins.inverse_net('ag_r5_inverse')
    import torch
    from visual_foresight_torch.models.convert import restore_network
    from visual_foresight_torch.models.inverse import InverseNet
    net = InverseNet(4, 7, 2)
    assert restore_network(net, inverse)
    assert net.head.weight.shape == (7 * 4, 256)
    assert torch.isfinite(net.head.weight).all()


# the config files whose dict no code of either package reads: each holds
# a ``configuration`` dict (a predictor's or the GDN trainer's settings)
# that only tests/test_configs.py loads; the port twins none of them
NO_READER = (
    'experiments/offline_exp/towel_classifier/conf.py',
    'experiments/robonet/pixel_cost/conf.py',
    'experiments/sawyer/mixed_objects/conf.py',
    'experiments/sawyer/pixel_cost/conf.py',
    'experiments/sawyer/registration_experiments/conf.py',
    'experiments/sawyer/registration_experiments/gdnconf.py',
    'experiments/sawyer/towel_classifier/conf.py',
    'experiments/sim/cartgripper_2d_grasping/nce_experiments/conf.py',
    'experiments/sim/cartgripper_2d_grasping/pixel_cost/conf.py',
    'experiments/sim/ensemble_grasping/conf.py',
)


def test_every_config_has_a_twin_or_no_reader():
    """Every ``*.py`` under ``experiments/``, ``data_collection/`` and
    ``benchmarks/`` is the source of exactly one twin, or on ``NO_READER``:
    a ``configuration`` dict and no ``config``, which no module of either
    package reads."""
    from test_torch_twins_collect import COLLECT_TWINS
    from test_torch_twins_robot import ROBOT_TWINS
    configs = sorted(os.path.relpath(p, REPO) for root in (
        'experiments', 'data_collection', 'benchmarks')
        for p in glob.glob(os.path.join(REPO, root, '**', '*.py'),
                           recursive=True))
    sources = [entry[0] for table in (TWINS, ROBOT_TWINS, COLLECT_TWINS)
               for entry in table.values()]
    assert len(sources) == len(set(sources))
    assert not set(sources) & set(NO_READER)
    assert sorted(sources + list(NO_READER)) == configs
    readers = []
    for root in ('visual_foresight_tpu', 'visual_foresight_torch'):
        for path in glob.glob(os.path.join(REPO, root, '**', '*.py'),
                              recursive=True):
            with open(path) as f:
                if re.search(r'\.configuration\b|\[.configuration.\]',
                             f.read()):
                    readers.append(path)
    assert readers == []
    for path in NO_READER:
        with open(os.path.join(REPO, path)) as f:
            text = f.read()
        assert re.search(r'^configuration = \{', text, re.M), path
        assert not re.search(r'^config = ', text, re.M), path
