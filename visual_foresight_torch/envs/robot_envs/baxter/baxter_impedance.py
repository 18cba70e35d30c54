"""Baxter impedance controller (reference ``robot_envs/baxter/baxter_impedance.py``).

Same streaming pattern as the Sawyer controller with baxter_interface in place
of intera; requires ROS + baxter SDK at runtime.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/baxter/baxter_impedance.py``."""

import logging

import numpy as np

from visual_foresight_torch.envs.util.interpolation import CSpline
from ..robot_controller_interface import RobotController

NEUTRAL_JOINT_ANGLES = np.array([0.0, -0.55, 0.0, 1.28, 0.0, 0.26, 0.0])


class BaxterImpedanceController(RobotController):
    def __init__(self, robot_name='baxter', print_debug=False,
                 email_cred_file='', log_file='', control_rate=800,
                 gripper_attached='default', limb='right'):
        super().__init__(robot_name, print_debug, email_cred_file, log_file,
                         control_rate, gripper_attached)
        import baxter_interface
        self._rs = baxter_interface.RobotEnable(baxter_interface.CHECK_VERSION)
        self._rs.enable()
        self._limb = baxter_interface.Limb(limb)
        self.joint_names = self._limb.joint_names()

    def move_to_neutral(self, duration=2.0):
        self.move_to_ja([NEUTRAL_JOINT_ANGLES], duration)

    def move_to_ja(self, waypoints, duration=1.5):
        prev = np.array([self._limb.joint_angle(j) for j in self.joint_names])
        spline = CSpline(np.array([prev] + list(waypoints)), duration)
        start = self._rospy.get_time()
        t = start
        while t - start < duration:
            pos = spline.get(t - start)[0]
            self._limb.set_joint_positions(dict(zip(self.joint_names, pos)))
            self._rate.sleep()
            t = self._rospy.get_time()

    def move_to_eep(self, target_pose, duration=1.5):
        ja = self._ik(target_pose[:3], target_pose[3:])
        self.move_to_ja([ja], duration)

    def _ik(self, xyz, quat_wxyz):
        import rospy
        from baxter_core_msgs.srv import SolvePositionIK, SolvePositionIKRequest
        from geometry_msgs.msg import Pose, PoseStamped
        from std_msgs.msg import Header
        svc = rospy.ServiceProxy(
            '/ExternalTools/right/PositionKinematicsNode/IKService',
            SolvePositionIK)
        pose = Pose()
        pose.position.x, pose.position.y, pose.position.z = xyz
        pose.orientation.w, pose.orientation.x, pose.orientation.y, \
            pose.orientation.z = quat_wxyz
        req = SolvePositionIKRequest()
        req.pose_stamp.append(PoseStamped(
            header=Header(stamp=rospy.Time.now(), frame_id='base'),
            pose=pose))
        resp = svc(req)
        if not resp.isValid[0]:
            raise ValueError('IK failed')
        return np.array(resp.joints[0].position)

    def get_joint_angles(self):
        return np.array([self._limb.joint_angle(j) for j in self.joint_names])

    def get_state(self):
        vel = np.array([self._limb.joint_velocity(j)
                        for j in self.joint_names])
        return self.get_joint_angles(), vel, self.get_cartesian_pose()

    def get_cartesian_pose(self):
        pose = self._limb.endpoint_pose()
        pos, ori = pose['position'], pose['orientation']
        return np.array([pos.x, pos.y, pos.z, ori.w, ori.x, ori.y, ori.z])
