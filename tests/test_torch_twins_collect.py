"""The data-collection twins against the JAX configs they copy, on the CPU.

- Each of the 24 twins (the ten ``data_collection/sim`` configs that
  earlier slices did not twin, the 14 robot collection configs of
  ``data_collection/{sawyer,baxter,kuka,widowx}``): its tree equals its
  source's, and its policy builds beside the JAX one with the same hparams
  (``test_torch_twins.py``'s checks).
- Each sim twin cut to T 6 (2 actions under repeat 3 for the random
  policies) and one trajectory, through the port's ``sim/run.py`` beside
  the JAX runner on its source cut the same way, the global streams seeded
  alike in both workers (``test_torch_collect.fixed_worker_seeds``): the
  same record streams and manifests, the same raw frames and pickles.
"""

import gzip
import os
import pickle
import random

import numpy as np
import pytest

from test_torch_collect import fixed_worker_seeds  # noqa: F401
from test_torch_planner import few_torch_threads  # noqa: F401
from test_torch_twins import DATA, check_twin_policy, check_twin_tree
from visual_foresight_torch.sim import run as t_run
from visual_foresight_tpu.sim import run as j_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGNS = os.path.join(REPO, 'visual_foresight_torch', 'campaigns')
SEED = 3
XZ, AG, PUSH = (3, 3, 1), (4, 5, 1), (4, 4, 2)
SIM = 'data_collection/sim/'
# twin -> (source, (adim, sdim, ncam) of its env, default weights, where
# the twin departs from its source: a default data directory outside the
# checkout becomes campaigns/runs/<twin>/data): as test_torch_twins.TWINS
SIM_TWINS = {
    'collect_sim_cartgripper_grasp_grasp_reflex_cubes': (
        SIM + 'cartgripper_grasp/grasp_reflex_cubes/hparams.py', AG, [], []),
    'collect_sim_cartgripper_grasp_grasp_reflex_lblocks': (
        SIM + 'cartgripper_grasp/grasp_reflex_lblocks/hparams.py', AG, [],
        []),
    'collect_sim_cartgripper_grasp_r4_taskgen': (
        SIM + 'cartgripper_grasp/r4_taskgen/hparams.py', AG, [], [DATA]),
    'collect_sim_cartgripper_grasp_r4_transport': (
        SIM + 'cartgripper_grasp/r4_transport/hparams.py', AG, [], [DATA]),
    'collect_sim_cartgripper_grasp_r4_transport_scripted': (
        SIM + 'cartgripper_grasp/r4_transport_scripted/hparams.py', AG, [],
        [DATA]),
    'collect_sim_cartgripper_pusher_cube_objects': (
        SIM + 'cartgripper_pusher/cube_objects/hparams.py', PUSH, [], []),
    'collect_sim_cartgripper_xz_grasp_cube_objects': (
        SIM + 'cartgripper_xz_grasp/cube_objects/hparams.py', XZ, [], []),
    'collect_sim_cartgripper_xz_grasp_r4_taskgen': (
        SIM + 'cartgripper_xz_grasp/r4_taskgen/hparams.py', XZ, [], [DATA]),
    'collect_sim_cartgripper_xz_grasp_r5_twocam': (
        SIM + 'cartgripper_xz_grasp/r5_twocam/hparams.py', (3, 3, 2), [],
        [DATA]),
    'collect_sim_cartgripper_xz_grasp_r5_twocam_tasks': (
        SIM + 'cartgripper_xz_grasp/r5_twocam_tasks/hparams.py', (3, 3, 2),
        [], [DATA]),
}
FIVE, ROBOT_AG, ROBOT_VANILLA = 5, (4, 5), (5, 5)
ROBOT_TWINS = {
    'collect_robot_sawyer_correlated_noise_bottombias': (
        'sawyer/correlated_noise_bottombias/hparams.py', ROBOT_AG + (5,)),
    'collect_robot_sawyer_five_view': ('sawyer/five_view/hparams.py',
                                       ROBOT_AG + (5,)),
    'collect_robot_sawyer_five_view_eps': ('sawyer/five_view/hparams_eps.py',
                                           ROBOT_VANILLA + (5,)),
    'collect_robot_sawyer_grasp': ('sawyer/grasp/hparams.py',
                                   ROBOT_AG + (5,)),
    'collect_robot_sawyer_grasp_eps': ('sawyer/grasp/hparams_eps.py',
                                       ROBOT_VANILLA + (5,)),
    'collect_robot_sawyer_hard_object_data': (
        'sawyer/hard_object_data/hparams.py', ROBOT_AG + (2,)),
    'collect_robot_sawyer_multi_env': ('sawyer/multi_env/hparams.py',
                                       ROBOT_AG + (2,)),
    'collect_robot_sawyer_towel_data_get_examples': (
        'sawyer/towel_data/get_examples.py', ROBOT_VANILLA + (5,)),
    'collect_robot_sawyer_towel_data': ('sawyer/towel_data/hparams.py',
                                        ROBOT_AG + (5,)),
    'collect_robot_baxter_3_view': ('baxter/3_View/hparams.py',
                                    ROBOT_AG + (3,)),
    'collect_robot_baxter_head_cam': ('baxter/head_cam/hparams.py',
                                      ROBOT_AG + (1,)),
    'collect_robot_kuka_3_view': ('kuka/3_View/hparams.py', ROBOT_AG + (4,)),
    'collect_robot_kuka_head_cam': ('kuka/head_cam/hparams.py',
                                    ROBOT_AG + (1,)),
    'collect_robot_widowx': ('widowx/hparams.py', ROBOT_AG + (3,)),
}
COLLECT_TWINS = dict(SIM_TWINS, **{
    name: ('data_collection/' + src, dims, [], [])
    for name, (src, dims) in ROBOT_TWINS.items()})


@pytest.mark.parametrize('name', sorted(COLLECT_TWINS))
def test_collect_twin_tree_equals_its_source(name):
    check_twin_tree(name, COLLECT_TWINS)


@pytest.mark.parametrize('name', sorted(COLLECT_TWINS))
def test_collect_twin_policy_builds_as_jax_does(name, tmp_path):
    check_twin_policy(name, COLLECT_TWINS, str(tmp_path))


# -- the sim twins' runs --------------------------------------------------
CUT = '''import copy
from {package}.sim.run import load_config
config = copy.deepcopy(load_config({src!r}))
config['agent'].update(T=6, data_save_dir={out!r})
if config['policy'].get('nactions'):
    config['policy'].update(nactions=2)
config.update(start_index=0, end_index=0, current_dir={root!r})
'''


def _cut(root, package, src):
    os.makedirs(str(root), exist_ok=True)
    path = os.path.join(str(root), 'cut.py')
    with open(path, 'w') as f:
        f.write(CUT.format(package=package, src=src, root=str(root),
                           out=os.path.join(str(root), 'data')))
    return path


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same(a, b, path):
    """Equal trees of pickled values: arrays exactly, dicts, lists, the
    rest by ``==``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], path + (k,))
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, path + (i,))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def _assert_same_data(got, want):
    """The same files under both data directories: record streams
    (decompressed) and manifests, frames byte for byte, pickles by value."""
    files = _files(got)
    assert files == _files(want) and files
    for f in files:
        a, b = os.path.join(got, f), os.path.join(want, f)
        if f.endswith('.pkl'):
            with open(a, 'rb') as x, open(b, 'rb') as y:
                _same(pickle.load(x), pickle.load(y), (f,))
            continue
        opener = gzip.open if f.endswith('.tfrecords') else open
        with opener(a, 'rb') as x, opener(b, 'rb') as y:
            assert x.read() == y.read(), f
    return files


@pytest.mark.parametrize('name', sorted(SIM_TWINS))
def test_sim_collect_twin_records_what_jax_records(name, tmp_path,
                                                   fixed_worker_seeds):
    source = os.path.join(REPO, SIM_TWINS[name][0])
    twin = os.path.join(CAMPAIGNS, name + '.py')
    for side, package, src, run in (
            ('jax', 'visual_foresight_tpu', source, j_run),
            ('port', 'visual_foresight_torch', twin, t_run)):
        config = _cut(tmp_path / side, package, src)
        np.random.seed(SEED)
        random.seed(SEED)
        run.main([config])
    files = _assert_same_data(str(tmp_path / 'port' / 'data'),
                              str(tmp_path / 'jax' / 'data'))
    assert any(f.endswith(('.tfrecords', '.png', '.jpg')) for f in files)
