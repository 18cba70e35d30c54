"""Baxter IK without the ``baxter_core_msgs`` ``SolvePositionIK`` service
(reference ``visual_mpc/envs/robot_envs/baxter/inverse_kinematics.py:24``,
same wrapper as the sawyer twin but parameterized by ``limb``).

Backed by the DLS solver in ``util/kinematics.py`` over the published Baxter
7-DoF DH approximation (arm-local frame: the torso -> arm-mount offset is
constant and irrelevant to relative MPC control).  The left arm mirrors the
right arm's geometry; ``limb`` selects the joint-name prefix.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/baxter/inverse_kinematics.py``.
"""

import numpy as np

from visual_foresight_torch.envs.robot_envs.util.kinematics import (
    IKError, ReferenceIKService, chain_from_dh, make_point_stamped,
    make_pose_stamped)

_SUFFIXES = ['s0', 's1', 'e0', 'e1', 'w0', 'w1', 'w2']
NEUTRAL = np.array([0.0, -0.55, 0.0, 1.284, 0.0, 0.262, 0.0])


def _build_chain(limb):
    return chain_from_dh(
        names=['{}_{}'.format(limb, s) for s in _SUFFIXES],
        a=[0.069, 0.0, 0.069, 0.0, 0.01, 0.0, 0.0],
        d=[0.27035, 0.0, 0.36435, 0.0, 0.37429, 0.0, 0.229525],
        alpha=[-np.pi / 2, np.pi / 2, -np.pi / 2, np.pi / 2,
               -np.pi / 2, np.pi / 2, 0.0],
        theta_offset=[0.0, np.pi / 2, 0.0, 0.0, 0.0, 0.0, 0.0],
        lower=[-1.7016, -2.147, -3.0541, -0.05, -3.059, -1.5707, -3.059],
        upper=[1.7016, 1.047, 3.0541, 2.618, 3.059, 2.094, 3.059])


CHAIN = _build_chain('right')
_services = {'right': ReferenceIKService(CHAIN, NEUTRAL)}


def _svc(limb):
    if limb not in _services:
        _services[limb] = ReferenceIKService(_build_chain(limb), NEUTRAL)
    return _services[limb]


def get_joint_angles(pose, seed_cmd=None, use_advanced_options=False,
                     limb='right'):
    """Reference ABI (baxter/inverse_kinematics.py:24): pose -> joint dict."""
    return _svc(limb).get_joint_angles(pose, seed_cmd, use_advanced_options)


def get_pose_stamped(x, y, z, o):
    return make_pose_stamped(x, y, z, o)


def get_point_stamped(x, y, z):
    return make_point_stamped(x, y, z)


def joint_state_from_cmd(cmd, limb='right'):
    return _svc(limb).array_from_cmd(cmd)


def forward_kinematics(cmd_or_array, limb='right'):
    if isinstance(cmd_or_array, dict):
        return _svc(limb).fk_cmd(cmd_or_array)
    return _svc(limb).chain.fk_pose(np.asarray(cmd_or_array))


__all__ = ['CHAIN', 'IKError', 'NEUTRAL', 'forward_kinematics',
           'get_joint_angles', 'get_point_stamped', 'get_pose_stamped',
           'joint_state_from_cmd']
