"""WidowX servo controller (reference ``robot_envs/widowx/widowx_controller.py``).

Arbotix servo control with pybullet-based IK/FK and joint lerp with an error
budget (too many tracking failures raise ``Environment_Exception``).  Requires
ROS + arbotix + pybullet at runtime.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/widowx/widowx_controller.py``.
"""

import logging
import threading
import time

import numpy as np

from visual_foresight_torch.agent.general_agent import Environment_Exception
from ..robot_controller_interface import RobotController

N_JOINTS = 5
NEUTRAL_JOINT_ANGLES = np.array([0.0, -0.8, 1.2, 0.6, 0.0])
MAX_ERRORS = 10
LERP_STEPS = 20


class WidowXController(RobotController):
    def __init__(self, robot_name='widowx', print_debug=False,
                 email_cred_file='', log_file='', control_rate=100,
                 gripper_attached='default'):
        super().__init__(robot_name, print_debug, email_cred_file, log_file,
                         control_rate, gripper_attached)
        import pybullet as p
        from arbotix_python.arbotix import ArbotiX
        self._p = p
        self._arbotix = ArbotiX('/dev/ttyUSB0')

        self._joint_lock = threading.Lock()
        self._error_count = 0

        # pybullet IK/FK on the URDF model (no GUI)
        self._sim = p.connect(p.DIRECT)
        import os
        urdf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'widowx.urdf')
        self._armID = p.loadURDF(urdf, physicsClientId=self._sim)
        self._ee_link = N_JOINTS

    # -- joint IO ------------------------------------------------------------------
    def _get_servo_positions(self):
        with self._joint_lock:
            return np.array([self._arbotix.getPosition(i + 1)
                             for i in range(N_JOINTS)])

    def _set_servo_positions(self, target):
        with self._joint_lock:
            for i, val in enumerate(target):
                self._arbotix.setPosition(i + 1, float(val))

    def move_to_ja(self, waypoints, duration=1.5):
        for target in waypoints:
            start = self._get_servo_positions()
            t0 = time.time()
            for step in range(LERP_STEPS):
                alpha = (step + 1) / LERP_STEPS
                self._set_servo_positions(start * (1 - alpha) + target * alpha)
                time.sleep(duration / len(waypoints) / LERP_STEPS)
            err = np.linalg.norm(self._get_servo_positions() - target)
            logging.getLogger('robot_logger').debug(
                'lerp took %.3f s, err %.4f', time.time() - t0, err)
            if err > 0.15:
                self._error_count += 1
                if self._error_count > MAX_ERRORS:
                    logging.getLogger('robot_logger').error(
                        'widowx exceeded error budget')
                    raise Environment_Exception
            else:
                self._error_count = max(0, self._error_count - 1)

    def move_to_neutral(self, duration=2.0):
        self.move_to_ja([NEUTRAL_JOINT_ANGLES], duration)

    def move_to_eep(self, target_pose, duration=1.5):
        xyz, quat = target_pose[:3], target_pose[3:]
        ja = self._ik(xyz, quat)
        self.move_to_ja([ja], duration)

    def _ik(self, xyz, quat_wxyz):
        quat_xyzw = np.roll(np.asarray(quat_wxyz), -1)
        sol = self._p.calculateInverseKinematics(
            self._armID, self._ee_link, xyz, quat_xyzw,
            physicsClientId=self._sim)
        return np.array(sol[:N_JOINTS])

    def _fk(self, joints):
        for i, j in enumerate(joints):
            self._p.resetJointState(self._armID, i, j,
                                    physicsClientId=self._sim)
        state = self._p.getLinkState(self._armID, self._ee_link,
                                     physicsClientId=self._sim)
        xyz, quat_xyzw = state[4], state[5]
        return np.concatenate([xyz, np.roll(quat_xyzw, 1)])

    def get_joint_angles(self):
        return self._get_servo_positions()

    def get_state(self):
        ja = self.get_joint_angles()
        return ja, None, self._fk(ja)   # no velocity readings on arbotix

    def get_cartesian_pose(self):
        return self._fk(self.get_joint_angles())
