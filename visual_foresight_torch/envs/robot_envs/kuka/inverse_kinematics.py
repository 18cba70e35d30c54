"""KUKA iiwa IK without MoveIt (reference
``visual_mpc/envs/robot_envs/kuka/inverse_kinematics.py`` routes through a
ROS IK service; ``kuka_interface.py`` through moveit_commander).

The iiwa 14 chain is transcribed from the iiwa_stack URDF: the seven joint
origins stack along +z with alternating z/y rotation axes, flange at 126 mm.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/kuka/inverse_kinematics.py``.
"""

import numpy as np

from visual_foresight_torch.envs.robot_envs.util.kinematics import (
    IKError, Joint, ReferenceIKService, SerialChain, make_point_stamped,
    make_pose_stamped)

JOINT_NAMES = ['iiwa_joint_{}'.format(i + 1) for i in range(7)]
# matches kuka_impedance.py NEUTRAL_JOINT_ANGLES
NEUTRAL = np.array([0.0, 0.6, 0.0, -1.2, 0.0, 0.8, 0.0])

_L = [0.1575, 0.2025, 0.2045, 0.2155, 0.1845, 0.2155, 0.081]
_AXES = [(0, 0, 1), (0, 1, 0), (0, 0, 1), (0, -1, 0),
         (0, 0, 1), (0, 1, 0), (0, 0, 1)]
_LIM = [2.967, 2.094, 2.967, 2.094, 2.967, 2.094, 3.054]

CHAIN = SerialChain(
    [Joint(name=n, origin_xyz=(0.0, 0.0, z), origin_rpy=(0.0, 0.0, 0.0),
           axis=ax, lower=-l, upper=l)
     for n, z, ax, l in zip(JOINT_NAMES, _L, _AXES, _LIM)],
    ee_offset_xyz=(0.0, 0.0, 0.126))

_service = ReferenceIKService(CHAIN, NEUTRAL)


def get_joint_angles(pose, seed_cmd=None, use_advanced_options=False,
                     limb=None):
    """Reference ABI (kuka/inverse_kinematics.py): pose -> joint dict."""
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
