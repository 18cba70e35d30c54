"""Franka Panda IK (the reference has no franka IK module at all — its
franka env is cartesian-impedance-only).  Providing one gives
``franka_impedance.py`` a joint-space move and closes the vendor-IK gap the
sawyer/baxter/kuka twins share.

Chain transcribed from the franka_description URDF (panda_arm.urdf): joint
origins/rpy mounts and the 107 mm flange.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/franka/inverse_kinematics.py``.
"""

import numpy as np

from visual_foresight_torch.envs.robot_envs.util.kinematics import (
    IKError, Joint, ReferenceIKService, SerialChain, make_point_stamped,
    make_pose_stamped)

JOINT_NAMES = ['panda_joint{}'.format(i + 1) for i in range(7)]
# matches franka_impedance.py NEUTRAL_JOINT_ANGLES
NEUTRAL = np.array([0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785])

_PI2 = np.pi / 2
_GEOM = [
    # (origin_xyz, origin_rpy, lower, upper)
    ((0.0, 0.0, 0.333), (0.0, 0.0, 0.0), -2.8973, 2.8973),
    ((0.0, 0.0, 0.0), (-_PI2, 0.0, 0.0), -1.7628, 1.7628),
    ((0.0, -0.316, 0.0), (_PI2, 0.0, 0.0), -2.8973, 2.8973),
    ((0.0825, 0.0, 0.0), (_PI2, 0.0, 0.0), -3.0718, -0.0698),
    ((-0.0825, 0.384, 0.0), (-_PI2, 0.0, 0.0), -2.8973, 2.8973),
    ((0.0, 0.0, 0.0), (_PI2, 0.0, 0.0), -0.0175, 3.7525),
    ((0.088, 0.0, 0.0), (_PI2, 0.0, 0.0), -2.8973, 2.8973),
]

CHAIN = SerialChain(
    [Joint(name=n, origin_xyz=xyz, origin_rpy=rpy, axis=(0, 0, 1),
           lower=lo, upper=hi)
     for n, (xyz, rpy, lo, hi) in zip(JOINT_NAMES, _GEOM)],
    ee_offset_xyz=(0.0, 0.0, 0.107))

_service = ReferenceIKService(CHAIN, NEUTRAL)


def get_joint_angles(pose, seed_cmd=None, use_advanced_options=False,
                     limb=None):
    del limb
    return _service.get_joint_angles(pose, seed_cmd, use_advanced_options)


def get_pose_stamped(x, y, z, o):
    return make_pose_stamped(x, y, z, o)


def get_point_stamped(x, y, z):
    return make_point_stamped(x, y, z)


def joint_state_from_cmd(cmd):
    return _service.array_from_cmd(cmd)


def forward_kinematics(cmd_or_array):
    if isinstance(cmd_or_array, dict):
        return _service.fk_cmd(cmd_or_array)
    return CHAIN.fk_pose(np.asarray(cmd_or_array))


__all__ = ['CHAIN', 'IKError', 'JOINT_NAMES', 'NEUTRAL',
           'forward_kinematics', 'get_joint_angles', 'get_point_stamped',
           'get_pose_stamped', 'joint_state_from_cmd']
