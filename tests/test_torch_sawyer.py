"""Port parity: the sawyer MuJoCo envs and the kinematics they share with
the robot path, against the JAX package.

- ``arm_model.scene_xml`` gives JAX's string; ``write_scene_xml`` writes it
  into the port's own assets directory.
- The kinematics (``envs/robot_envs/util/kinematics.py``,
  ``sawyer/inverse_kinematics.py``): forward kinematics, Jacobians, IK
  solutions (with and without an orientation and a nullspace goal), an
  unreachable target's ``IKError`` and the reference IK service's joint
  dict, each equal to JAX's.
- A seeded ``SawyerArmEnv`` episode (one object, 48x64, as
  ``tests/test_sawyer_arm.py``'s fixture; T 4) and a ``SawyerEnv`` one:
  every observation, the rendered frames too, bit for bit; the reset state
  of the JAX episode rebuilds the same scene in both packages.
- The twin configs ``campaigns/collect_sawyer_arm.py`` and
  ``collect_sawyer_grasp.py`` cut to T 3 and two trajectories, beside the
  JAX runner on their sources cut the same way: the same records and raw
  folders (frames byte for byte, pickles equal when loaded; the
  runners' workers seed with None and ``SawyerArmEnv`` draws from an
  unseeded ``RandomState``; here those seeds are fixed on both sides).
- ``chip_smoke.collect_sawyer`` (the card script's sawyer phase, which the
  card machine skips while it has no MuJoCo that renders) records its two
  trajectories of T 6 here, the workers' seeds fixed as for the twins, and
  reads them back.
"""

import gzip
import os
import pickle
import random

import numpy as np
import pytest

from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.envs.mujoco_env.sawyer_env import (
    arm_model as t_arm, base_sawyer_env as t_base, sawyer_arm_env as t_env)
from visual_foresight_torch.envs.robot_envs.sawyer import (
    inverse_kinematics as t_ik)
from visual_foresight_torch.envs.robot_envs.util import (
    kinematics as t_kin)
from visual_foresight_torch.sim import run as t_run
from visual_foresight_tpu.envs.mujoco_env.sawyer_env import (
    arm_model as j_arm, base_sawyer_env as j_base, sawyer_arm_env as j_env)
from visual_foresight_tpu.envs.robot_envs.sawyer import (
    inverse_kinematics as j_ik)
from visual_foresight_tpu.envs.robot_envs.util import kinematics as j_kin
from visual_foresight_tpu.sim import run as j_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
PARAMS = {'num_objects': 1, 'viewer_image_height': 48,
          'viewer_image_width': 64, 'cube_objects': True}


def test_scene_xml_equals_jax(tmp_path):
    xml = t_arm.scene_xml()
    assert xml == j_arm.scene_xml()
    assert t_arm.arm_xml_lines() == j_arm.arm_xml_lines()
    path = t_arm.write_scene_xml(str(tmp_path))
    assert open(path).read() == xml
    assert os.path.normpath(t_env.ASSET_BASE_PATH) == os.path.join(
        REPO, 'visual_foresight_torch', 'envs', 'mujoco_env', 'assets')


def _targets():
    rng = np.random.RandomState(5)
    for _ in range(4):
        q = j_ik.CHAIN.clip(j_ik.NEUTRAL + rng.randn(7) * 0.3)
        yield q, j_ik.CHAIN.fk_pose(q)


@pytest.mark.parametrize('mode', ['pose', 'position', 'nullspace'])
def test_ik_solutions_equal_jax(mode):
    for q, pose in _targets():
        for side in (t_ik, j_ik):
            np.testing.assert_array_equal(side.CHAIN.fk(q),
                                          j_ik.CHAIN.fk(q))
            np.testing.assert_array_equal(side.CHAIN.jacobian(q),
                                          j_ik.CHAIN.jacobian(q))
        kw = {'seed': j_ik.NEUTRAL}
        if mode != 'position':
            kw['quat_wxyz'] = pose[3:]
        if mode == 'nullspace':
            kw['nullspace_goal'] = j_ik.NEUTRAL
        got = t_ik.CHAIN.ik(pose[:3], **kw)
        want = j_ik.CHAIN.ik(pose[:3], **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(t_ik.CHAIN.fk_pose(got)[:3], pose[:3],
                                   atol=1e-4)


def test_ik_service_and_errors_equal_jax():
    q, pose = next(_targets())
    for use in (False, True):
        got = t_ik.get_joint_angles(t_ik.get_pose_stamped(*pose[:3],
                                                          pose[3:]),
                                    use_advanced_options=use)
        want = j_ik.get_joint_angles(j_ik.get_pose_stamped(*pose[:3],
                                                           pose[3:]),
                                     use_advanced_options=use)
        assert got == want and sorted(got) == t_ik.JOINT_NAMES
    np.testing.assert_array_equal(
        t_ik.forward_kinematics(got), j_ik.forward_kinematics(want))
    point = t_ik.get_point_stamped(*pose[:3])
    assert t_kin.pose_to_arrays(point)[1] is None
    for side, kin in ((t_ik, t_kin), (j_ik, j_kin)):
        with pytest.raises(kin.IKError):
            side.CHAIN.ik(np.array([3.0, 0.0, 0.0]), max_iters=20)
    chain = t_kin.chain_from_dh(['a', 'b'], [0.1, 0.2], [0.3, 0.0],
                                [np.pi / 2, 0.0], [-2, -2], [2, 2],
                                theta_offset=[0.1, 0.0])
    jchain = j_kin.chain_from_dh(['a', 'b'], [0.1, 0.2], [0.3, 0.0],
                                 [np.pi / 2, 0.0], [-2, -2], [2, 2],
                                 theta_offset=[0.1, 0.0])
    np.testing.assert_array_equal(chain.fk([0.3, -0.4]),
                                  jchain.fk([0.3, -0.4]))


def _episode(cls, actions, reset_state=None, params=PARAMS):
    """Seeded env: reset and ``actions``; every observation."""
    np.random.seed(SEED)
    random.seed(SEED)
    env = cls(dict(params), reset_state)
    env._rng = np.random.RandomState(7)
    try:
        obs, rs = env.reset(reset_state)
        out = [obs]
        for a in actions:
            out.append(env.step(a))
        return out, rs, env.valid_rollout()
    finally:
        env.close()


def _assert_same_obs(got, want):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), t
        for key in w:
            np.testing.assert_array_equal(g[key], w[key],
                                          err_msg='{} t={}'.format(key, t))


def _assert_same_tree(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_same_tree(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_tree(g, w)
    else:
        np.testing.assert_array_equal(got, want)


ARM_ACTIONS = [np.array([0.04, -0.04, -0.02, 0.2, -1.0]),
               np.array([-0.04, 0.03, 0.01, -0.1, 0.3]),
               np.array([0.0, 0.0, 0.0, 0.0, -0.3])]


def test_sawyer_arm_episode_equals_jax():
    got, t_rs, t_valid = _episode(t_env.SawyerArmEnv, ARM_ACTIONS)
    want, j_rs, j_valid = _episode(j_env.SawyerArmEnv, ARM_ACTIONS)
    _assert_same_obs(got, want)
    assert t_valid == j_valid
    assert got[0]['images'].shape == (2, 48, 64, 3)
    assert got[2]['state'][4] == 1.0 and got[3]['state'][4] == -1.0
    np.testing.assert_array_equal(t_rs['qpos_all'], j_rs['qpos_all'])
    _assert_same_tree(t_rs['reset_xml'], j_rs['reset_xml'])
    # the JAX episode's reset state rebuilds the same scene in both
    again, _, _ = _episode(t_env.SawyerArmEnv, ARM_ACTIONS[:1], j_rs)
    jagain, _, _ = _episode(j_env.SawyerArmEnv, ARM_ACTIONS[:1], j_rs)
    _assert_same_obs(again, jagain)
    np.testing.assert_allclose(again[0]['object_qpos'],
                               want[0]['object_qpos'], atol=0.05)


def test_sawyer_workspace_episode_equals_jax():
    params = {'num_objects': 2, 'viewer_image_height': 48,
              'viewer_image_width': 64}
    actions = [np.array([0.02, -0.01, 0.03, 0.1, 1.0])] * 2
    got, _, _ = _episode(t_base.SawyerEnv, actions, params=params)
    want, _, _ = _episode(j_base.SawyerEnv, actions, params=params)
    _assert_same_obs(got, want)
    assert got[0]['images'].shape == (2, 48, 64, 3)
    assert got[-1]['eef_quat'].shape == (4,)


# -- the twin configs --------------------------------------------------------

TWINS = {
    'sawyer_arm': ('collect_sawyer_arm.py',
                   os.path.join('sawyer_arm', 'hparams.py')),
    'sawyer_grasp': ('collect_sawyer_grasp.py',
                     os.path.join('sawyer_grasp', 'hparams.py')),
}

CUT = '''import copy
from {package}.sim.run import load_config
config = copy.deepcopy(load_config({src!r}))
# cut to T 3 (one action under repeat 3) and two trajectories
config['agent'].update(T=3, data_save_dir={out!r})
config['policy'].update(nactions=1)
config.update(start_index=0, end_index=1, traj_per_file=2,
              current_dir={root!r})
'''


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


class _SeededRandomState(np.random.RandomState):
    def __init__(self, seed=None):
        super().__init__(SEED if seed is None else seed)


@pytest.fixture
def fixed_worker_seeds(monkeypatch):
    """The runners' workers seed the global streams with None, and
    ``SawyerArmEnv`` draws its scenes from an unseeded ``RandomState``
    (in both packages); here each takes ``SEED``, on both sides."""
    for module, name in ((np.random, 'seed'), (random, 'seed')):
        seed = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda s=None, _seed=seed: _seed(
                                SEED if s is None else s))
    monkeypatch.setattr(np.random, 'RandomState', _SeededRandomState)


@pytest.mark.parametrize('twin', sorted(TWINS))
def test_twin_config_records_what_jax_records(tmp_path, fixed_worker_seeds,
                                              twin):
    port_cfg, source = TWINS[twin]
    for side, package, src, run in (
            ('jax', 'visual_foresight_tpu',
             os.path.join(REPO, 'data_collection', 'sim', source), j_run),
            ('port', 'visual_foresight_torch',
             os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                          port_cfg), t_run)):
        root = tmp_path / side
        os.makedirs(str(root))
        config = str(root / 'cut.py')
        with open(config, 'w') as f:
            f.write(CUT.format(package=package, src=src, root=str(root),
                               out=str(root / 'data')))
        np.random.seed(SEED)
        random.seed(SEED)
        run.main([config])
    data = {s: str(tmp_path / s / 'data') for s in ('jax', 'port')}
    files = _files(data['port'])
    assert files == _files(data['jax'])
    # the arm config writes records, the grasp config raw folders
    kind = '.tfrecords' if twin == 'sawyer_arm' else '.pkl'
    assert sum(f.endswith(kind) for f in files) >= 2
    for f in files:
        a, b = (os.path.join(data[s], f) for s in ('port', 'jax'))
        if f.endswith('.pkl'):
            with open(a, 'rb') as fa, open(b, 'rb') as fb:
                _assert_same_tree(pickle.load(fa), pickle.load(fb))
            continue
        opener = gzip.open if f.endswith('.tfrecords') else open
        with opener(a, 'rb') as fa, opener(b, 'rb') as fb:
            assert fa.read() == fb.read(), f


def test_smoke_collects_sawyer_on_the_cpu(tmp_path, fixed_worker_seeds):
    import chip_smoke
    wall = chip_smoke.collect_sawyer(str(tmp_path), os.environ['MUJOCO_GL'])
    assert wall > 0
    assert sum(f.endswith('.tfrecords')
               for f in _files(str(tmp_path / 'data'))) >= 1
