"""Autograsp primitives shared by sim and robot envs.

Semantics parity with the reference's ``visual_mpc/envs/util/action_util.py``:
the policy commands only xyz/theta deltas; the gripper is a latch that closes
whenever the hand drops below ``zthresh`` and releases only when ``reopen``
is enabled and no grasp condition holds.
"""

import numpy as np


def autograsp_grip_logic(gripper_zpos, zthresh, gripper_closed, reopen,
                         grasp_condition):
    """Next latch state for the gripper (True = closed)."""
    if gripper_zpos < zthresh:
        return True
    if reopen and not grasp_condition:
        return False
    return gripper_closed


def autograsp_dynamics(prev_target_qpos, action, gripper_closed, gripper_zpos,
                       zthresh, reopen, grasp_condition, open_action=-1,
                       close_action=1):
    """Integrate a 4-dim xyz/theta delta into a 5-dim target qpos whose last
    dim is the latched grip command.

    :return: (target_qpos, gripper_closed)
    """
    gripper_closed = autograsp_grip_logic(
        gripper_zpos, zthresh, gripper_closed, reopen, grasp_condition)
    target_qpos = np.zeros_like(prev_target_qpos)
    target_qpos[:4] = prev_target_qpos[:4] + action[:4]
    target_qpos[4] = close_action if gripper_closed else open_action
    return target_qpos, gripper_closed
