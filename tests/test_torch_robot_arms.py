"""The port's arm controllers and robot tools against the JAX package's, on
the CPU (no ROS, no arm).

- ``get_controller_class`` names the same controller for every robot type,
  returns a class given as it is, and raises for an unknown type.
- The baxter, franka and kuka IK (the same numpy as JAX's, on the port's
  kinematics): solutions bit for bit on ``tests/test_kinematics.py``'s
  targets (round trips from seeded joint draws, the position-only solve,
  the service ABI, baxter's left limb).
- The kuka planner behind the fake commander: plans, the workspace clamp,
  neutral moves, the redistribution sweep and the plan statistics equal
  JAX's; the franka joint-trajectory samples bit for bit.
- ``CalibratedCamera``'s round trip and its homography equal JAX's;
  ``record_motion`` records a fake controller's joints and writes the pkl.
- ``get_points`` and ``launchers``: their CLIs give the commands JAX's give,
  and the controllers stop at the SDK boundary (``ImportError`` without
  ROS); the grippers' and controllers' SDK imports sit in their
  constructors.
"""

import importlib
import pickle
import sys
from unittest import mock

import numpy as np
import pytest

from test_torch_planner import few_torch_threads  # noqa: F401

ROBOTS = ['sawyer', 'widowx', 'franka', 'baxter', 'kuka']
IK_ROBOTS = ['baxter', 'franka', 'kuka']


def both(module):
    """The JAX package's module ``module`` and the port's."""
    return [importlib.import_module('{}.{}'.format(pkg, module))
            for pkg in ('visual_foresight_tpu', 'visual_foresight_torch')]


@pytest.fixture
def excepthook():
    """A controller's constructor installs its crash hook process-wide."""
    hook = sys.excepthook
    yield
    sys.excepthook = hook


@pytest.mark.parametrize('robot', ROBOTS)
def test_controller_registry_matches_jax(robot):
    j, t = both('envs.robot_envs')
    jcls, tcls = j.get_controller_class(robot), t.get_controller_class(robot)
    assert tcls.__name__ == jcls.__name__
    assert tcls.__module__ == jcls.__module__.replace(
        'visual_foresight_tpu', 'visual_foresight_torch')
    assert t.get_controller_class(dict) is dict
    with pytest.raises(NotImplementedError, match='ur5'):
        t.get_controller_class('ur5')


@pytest.mark.parametrize('robot', IK_ROBOTS)
def test_ik_matches_jax(robot):
    j, t = both('envs.robot_envs.{}.inverse_kinematics'.format(robot))
    np.testing.assert_array_equal(t.NEUTRAL, j.NEUTRAL)
    rng = np.random.RandomState(3)
    chain = t.CHAIN
    for _ in range(5):
        q = rng.uniform(chain.lower, chain.upper)
        q = 0.7 * q + 0.3 * 0.5 * (chain.lower + chain.upper)
        pose = chain.fk_pose(q)
        np.testing.assert_array_equal(pose, j.CHAIN.fk_pose(q))
        seed = chain.clip(q + rng.randn(chain.n) * 0.1)
        np.testing.assert_array_equal(
            chain.ik(pose[:3], pose[3:], seed=seed),
            j.CHAIN.ik(pose[:3], pose[3:], seed=seed))
    target = chain.fk_pose(t.NEUTRAL)[:3] + np.array([0.02, -0.03, 0.01])
    np.testing.assert_array_equal(chain.ik(target, None, seed=t.NEUTRAL),
                                  j.CHAIN.ik(target, None, seed=j.NEUTRAL))
    pose7 = chain.fk_pose(t.NEUTRAL)
    seed = {n: float(v) for n, v in zip(chain.joint_names, t.NEUTRAL)}
    cmds = [m.get_joint_angles(
        m.get_pose_stamped(pose7[0], pose7[1], pose7[2], pose7[3:]),
        seed_cmd=seed, use_advanced_options=True) for m in (j, t)]
    assert cmds[0] == cmds[1]
    np.testing.assert_array_equal(t.forward_kinematics(cmds[1]),
                                  j.forward_kinematics(cmds[0]))
    np.testing.assert_array_equal(t.joint_state_from_cmd(cmds[1]),
                                  j.joint_state_from_cmd(cmds[0]))
    if robot == 'baxter':
        left = [m.get_joint_angles(m.get_pose_stamped(*pose7[:3], pose7[3:]),
                                   limb='left') for m in (j, t)]
        assert left[0] == left[1] and all(k.startswith('left_')
                                          for k in left[1])


def _kuka_run(module, drive):
    iface = module.KukaInterface(commander=module.FakeCommander(), seed=0)
    out = drive(iface, module)
    plans = [(p.points, p.dt) for p in iface._commander.executed]
    return out, plans, iface.traj_num, iface.get_kuka_state()


KUKA_DRIVES = {
    'plan': lambda i, m: i.move_kuka_to_eep(
        np.array([0.6, 0.0, 0.2, 0, 1, 0, 0])),
    'clamp': lambda i, m: i.move_kuka_to_eep(
        np.array([2.0, -2.0, 0.0, 0, 1, 0, 0])),
    'neutral': lambda i, m: [i.move_kuka_to_neutral(),
                             i.move_kuka_to_neutral()],
    'sweep': lambda i, m: i.redistribute_kuka_objects(),
    'statistics': lambda i, m: [
        i._calc_plan_statistics(m.Plan(
            points=np.linspace(np.zeros(7), np.full(7, 0.5), 8), dt=0.1)),
        i._calc_plan_statistics(m.Plan(points=np.zeros((0, 7)), dt=0.1)),
        i.get_xyz_quat(), i.get_kuka_joint_angles_names()],
}


@pytest.mark.parametrize('drive', sorted(KUKA_DRIVES))
def test_kuka_planner_matches_jax(drive):
    j, t = both('envs.robot_envs.kuka.kuka_interface')
    want, got = (_kuka_run(m, KUKA_DRIVES[drive]) for m in (j, t))
    assert len(got[1]) == len(want[1])
    assert len(got[1]) > 0 or drive == 'statistics'
    for (gp, gdt), (wp, wdt) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gp, wp)
        assert gdt == wdt
    assert got[2] == want[2]
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)
    assert repr(got[0]) == repr(want[0])
    assert all(len(p) <= t.MAX_PATH_LENGTH for p, _ in got[1])
    if drive == 'sweep':
        assert len(got[1]) == 25


def test_franka_joint_trajectory_matches_jax():
    j, t = both('envs.robot_envs.franka.franka_impedance')
    args = (np.zeros(7), [np.full(7, 0.4), np.full(7, -0.2)], 2.0)
    got = t.joint_trajectory_samples(*args, rate=50)
    want = j.joint_trajectory_samples(*args, rate=50)
    assert got[0].shape == (100, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_camera_calibration_matches_jax():
    j, t = both('sim.util.camera_calib')
    rng = np.random.RandomState(0)
    H_true = np.array([[0.002, 0.0001, -0.3], [0.0002, -0.0025, 0.5],
                       [0.00001, 0.00002, 1.0]])
    pixels = rng.uniform(0, 480, (12, 2))
    world = np.concatenate([pixels, np.ones((12, 1))], 1) @ H_true.T
    world = world[:, :2] / world[:, 2:3]
    cams = [m.CalibratedCamera(pixels, world) for m in (j, t)]
    np.testing.assert_array_equal(cams[1]._H, cams[0]._H)
    np.testing.assert_allclose(cams[1].pixel_to_world(pixels), world,
                               atol=1e-6)
    np.testing.assert_allclose(cams[1].world_to_pixel(world), pixels,
                               atol=1e-4)


class _Joints:
    """A controller that reports a counter as its joint angles."""

    def __init__(self, robot_name, gripper_attached='none'):
        self.n = 0

    def get_joint_angles(self):
        self.n += 1
        return np.full(7, float(self.n))


def test_record_motion_writes_the_joints(tmp_path):
    from visual_foresight_torch.sim.util import record_motion
    joints = record_motion.record(_Joints('x'), rate_hz=200.0,
                                  duration_s=0.05)
    assert len(joints) >= 2
    np.testing.assert_array_equal(joints[1], np.full(7, 2.0))
    out = tmp_path / 'sub' / 'pushback_traj_vestri.pkl'
    with mock.patch('visual_foresight_torch.envs.robot_envs.'
                    'get_controller_class', return_value=_Joints), \
            mock.patch('builtins.input', lambda prompt: ''):
        record_motion.main(['sawyer', 'vestri', '--rate', '200',
                            '--duration', '0.05', '--out', str(out)])
    with open(str(out), 'rb') as f:
        saved = pickle.load(f)
    assert len(saved) >= 2 and saved[0].shape == (7,)


@pytest.mark.parametrize('argv', [
    ['start_gripper', '--ip', '10.0.0.2', '--port', '1001'],
    ['start_impedance', '--rate', '20', '--stiffness', '1', '2', '3', '4',
     '5', '6', '--mode', '1', '0', '1', '0', '1', '0']],
    ids=['start_gripper', 'start_impedance'])
def test_launchers_cli_matches_jax(argv):
    commands = []
    for m in both('envs.robot_envs.util.launchers'):
        seen = []

        def supervise(factory, retry_delay=2.0, name='process'):
            factory()
            seen.append((name, retry_delay))
        with mock.patch.object(m, 'supervise', supervise), \
                mock.patch.object(m.subprocess, 'Popen',
                                  lambda cmd: seen.append(cmd)), \
                mock.patch.object(m.subprocess, 'run',
                                  lambda cmd, check: seen.append(cmd)):
            m.main(argv)
        commands.append(seen)
    assert commands[0] == commands[1] and len(commands[1]) >= 2


def test_get_points_and_controllers_stop_at_the_sdk(excepthook):
    from visual_foresight_torch.envs.robot_envs.util import get_points
    for robot in ('sawyer', 'baxter', 'kuka'):
        with pytest.raises(ImportError):
            get_points.make_controller(robot, 'right')
    with pytest.raises(NotImplementedError):
        get_points.make_controller('ur5', 'right')
    with pytest.raises(ImportError):
        get_points.main(['--robot', 'sawyer'])
    from visual_foresight_torch.envs.robot_envs import get_controller_class
    for robot in ROBOTS:
        with pytest.raises(ImportError):
            get_controller_class(robot)('r', gripper_attached='none')


@pytest.mark.parametrize('module,cls', [
    ('sawyer.default_sawyer_gripper', 'SawyerDefaultGripper'),
    ('baxter.default_baxter_gripper', 'BaxterDefaultGripper'),
    ('kuka.default_kuka_gripper', 'KukaDefaultGripper'),
    ('weiss.wsg50_gripper', 'WSG50Gripper')])
def test_grippers_import_their_sdk_when_built(module, cls):
    mod = importlib.import_module(
        'visual_foresight_torch.envs.robot_envs.grippers.' + module)
    with pytest.raises(ImportError):
        getattr(mod, cls)()
