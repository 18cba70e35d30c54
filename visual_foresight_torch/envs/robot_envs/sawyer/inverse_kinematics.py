"""Sawyer IK without the intera ``SolvePositionIK`` service.

The port's copy of ``visual_foresight_tpu/envs/robot_envs/sawyer/
inverse_kinematics.py``.

The reference resolves poses through Rethink's on-robot IK daemon
(``visual_mpc/envs/robot_envs/sawyer/inverse_kinematics.py:24-104``), so the
control stack dies off-robot.  This module keeps that call surface —
``get_joint_angles(pose, seed_cmd, use_advanced_options)`` returning a
``right_j*`` command dict, plus the ``get_pose_stamped``/``get_point_stamped``
constructors — on top of the self-contained DLS solver in
``util/kinematics.py``.  On a real Sawyer the intera service (when running)
can still be preferred by the caller; this is the always-available fallback.

Chain geometry is the published 7-DoF Sawyer DH approximation; deployments
wanting millimetre fidelity should calibrate the table.  The solver contract
(seeding, nullspace bias, joint limits) is what the tests pin down.
"""

import numpy as np

from visual_foresight_torch.envs.robot_envs.util.kinematics import (
    IKError, ReferenceIKService, chain_from_dh, make_point_stamped,
    make_pose_stamped)

JOINT_NAMES = ['right_j{}'.format(i) for i in range(7)]
# matches sawyer/control_util.py NEUTRAL_JOINT_ANGLES
NEUTRAL = np.array([0.412271, -0.434908, -1.198768, 1.795462,
                    1.160788, 1.107675, -1.11748145])

CHAIN = chain_from_dh(
    names=JOINT_NAMES,
    a=[0.081, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    d=[0.317, 0.1925, 0.4, 0.1685, 0.4, 0.1363, 0.13375],
    alpha=[-np.pi / 2, np.pi / 2, -np.pi / 2, np.pi / 2,
           -np.pi / 2, np.pi / 2, 0.0],
    lower=[-3.0503, -3.8095, -3.0426, -3.0439, -2.9761, -2.9761, -4.7124],
    upper=[3.0503, 2.2736, 3.0426, 3.0439, 2.9761, 2.9761, 4.7124])

_service = ReferenceIKService(CHAIN, NEUTRAL)


def get_joint_angles(pose, seed_cmd=None, use_advanced_options=False,
                     limb='right'):
    """Reference ABI (sawyer/inverse_kinematics.py:24): pose -> joint dict."""
    del limb   # single-arm robot; kept for call-site compatibility
    return _service.get_joint_angles(pose, seed_cmd, use_advanced_options)


def get_pose_stamped(x, y, z, o):
    """o: quaternion wxyz (array or the EEP tail) — reference line 118."""
    return make_pose_stamped(x, y, z, o)


def get_point_stamped(x, y, z):
    return make_point_stamped(x, y, z)


def joint_state_from_cmd(cmd):
    """Ordered (7,) array from a right_j* command dict."""
    return _service.array_from_cmd(cmd)


def forward_kinematics(cmd_or_array):
    """(7,) [xyz, quat wxyz] end-effector pose — FK twin used by tests."""
    if isinstance(cmd_or_array, dict):
        return _service.fk_cmd(cmd_or_array)
    return CHAIN.fk_pose(np.asarray(cmd_or_array))


__all__ = ['CHAIN', 'IKError', 'JOINT_NAMES', 'NEUTRAL',
           'forward_kinematics', 'get_joint_angles', 'get_point_stamped',
           'get_pose_stamped', 'joint_state_from_cmd']
