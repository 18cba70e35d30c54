"""Sawyer impedance controller (reference ``robot_envs/sawyer/sawyer_impedance.py``).

800 Hz joint-command streaming: quintic-spline cartesian interpolation turned
into a per-tick IK lookup table, clamped-cubic-spline joint moves, auto
re-enable loop, and pre-recorded pushback replay for object redistribution.
Requires ROS + intera at runtime.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/sawyer/sawyer_impedance.py``.
"""

import logging
import os
import pickle as pkl

import numpy as np

from visual_foresight_torch.envs.util.interpolation import CSpline
from ..robot_controller_interface import RobotController
from .control_util import (CONTROL_PERIOD, NEUTRAL_JOINT_ANGLES, RESET_SKIP,
                           LatestEEObs, max_accel_mag, max_vel_mag,
                           precalculate_interpolation)


class SawyerImpedanceController(RobotController):
    def __init__(self, robot_name='sawyer', print_debug=False,
                 email_cred_file='', log_file='', control_rate=800,
                 gripper_attached='wsg-50'):
        super().__init__(robot_name, print_debug, email_cred_file, log_file,
                         control_rate, gripper_attached)
        import intera_interface
        import rospy
        from intera_core_msgs.msg import JointCommand
        self._JointCommand = JointCommand
        self._rospy = rospy

        self._rs = intera_interface.RobotEnable(intera_interface.CHECK_VERSION)
        self._limb = intera_interface.Limb('right')
        self.joint_names = self._limb.joint_names()
        self._ep_handler = LatestEEObs()
        self._cmd_publisher = rospy.Publisher(
            '/robot/limb/right/joint_command', JointCommand, queue_size=100)
        self._ik = self._build_ik()

    def _build_ik(self):
        """IK through the intera IK service; signature
        (xyz, quat_wxyz, seed_cmd_dict) -> joint cmd dict."""
        import rospy
        from geometry_msgs.msg import Pose, PoseStamped
        from intera_core_msgs.srv import SolvePositionIK, SolvePositionIKRequest
        from std_msgs.msg import Header

        svc = rospy.ServiceProxy('/ExternalTools/right/PositionKinematicsNode/'
                                 'IKService', SolvePositionIK)

        def ik_fn(xyz, quat_wxyz, seed_cmd):
            pose = Pose()
            pose.position.x, pose.position.y, pose.position.z = xyz
            pose.orientation.w, pose.orientation.x, pose.orientation.y, \
                pose.orientation.z = quat_wxyz
            req = SolvePositionIKRequest()
            req.pose_stamp.append(PoseStamped(
                header=Header(stamp=rospy.Time.now(), frame_id='base'),
                pose=pose))
            req.tip_names.append('right_hand')
            resp = svc(req)
            if resp.result_type[0] <= 0:
                raise ValueError('IK failed')
            return dict(zip(resp.joints[0].name, resp.joints[0].position))

        return ik_fn

    def _try_enable(self):
        """The impedance launch script re-enables the robot after trips; wait
        for that, and shut down if it never recovers."""
        i = 0
        while not self._rs.state().enabled and i < 50:
            self._rospy.sleep(10)
            i += 1
        if not self._rs.state().enabled:
            logging.getLogger('robot_logger').error(
                'robot was disabled — please manually re-enable')
            self._rospy.signal_shutdown('robot disabled')

    def move_to_neutral(self, duration=2):
        self.move_to_ja([NEUTRAL_JOINT_ANGLES], duration)

    def move_to_eep(self, target_pose, duration=1.5):
        p1, q1 = self.get_xyz_quat()
        p2, q2 = target_pose[:3], target_pose[3:]
        last_pos = self.get_joint_angles()
        last_cmd = self._limb.joint_angles()

        interp_jas = precalculate_interpolation(
            p1, q1, p2, q2, duration, last_pos, last_cmd, self.joint_names,
            self._ik)

        i = 0
        self._rate.sleep()
        start_time = self._rospy.get_time()
        t = start_time
        while t - start_time < duration:
            lookup = min(int(min(t - start_time, duration) / CONTROL_PERIOD),
                         len(interp_jas) - 1)
            self._send_pos_command(interp_jas[lookup])
            i += 1
            self._rate.sleep()
            t = self._rospy.get_time()
        logging.getLogger('robot_logger').debug(
            'effective rate: %.1f Hz', i / (self._rospy.get_time() - start_time))

    def move_to_ja(self, waypoints, duration=1.5):
        self._try_enable()
        prev_joint = np.array([self._limb.joint_angle(j)
                               for j in self.joint_names])
        waypoints = np.array([prev_joint] + list(waypoints))
        spline = CSpline(waypoints, duration)

        start_time = self._rospy.get_time()
        finish_time = start_time + duration
        t = start_time
        while t < finish_time:
            pos, velocity, acceleration = spline.get(t - start_time)
            command = self._JointCommand()
            command.mode = self._JointCommand.POSITION_MODE
            command.names = self.joint_names
            command.position = pos
            command.velocity = np.clip(velocity, -max_vel_mag, max_vel_mag)
            command.acceleration = np.clip(acceleration, -max_accel_mag,
                                           max_accel_mag)
            self._cmd_publisher.publish(command)
            self._rate.sleep()
            t = self._rospy.get_time()

        for _ in range(10):
            command = self._JointCommand()
            command.mode = self._JointCommand.POSITION_MODE
            command.names = self.joint_names
            command.position = waypoints[-1]
            self._cmd_publisher.publish(command)
            self._rate.sleep()

    def _send_pos_command(self, pos):
        self._try_enable()
        command = self._JointCommand()
        command.mode = self._JointCommand.POSITION_MODE
        command.names = self.joint_names
        command.position = pos
        self._cmd_publisher.publish(command)

    def redistribute_objects(self):
        """Replay the pre-recorded sweep that pushes objects back to the bin
        center (recorded via foresight_rospkg/record_motion)."""
        logging.getLogger('robot_logger').info('redistribute...')
        file = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), 'recorded_trajectories',
            'pushback_traj_{}.pkl'.format(self._robot_name))
        with open(file, 'rb') as f:
            joint_pos = pkl.load(f)
        for t in range(0, len(joint_pos), RESET_SKIP):
            joint_t = joint_pos[t]
            if isinstance(joint_t, np.ndarray):
                pos_arr = joint_t
            else:
                pos_arr = np.array([joint_t[j] for j in self.joint_names])
            self.move_to_ja([pos_arr])

    def get_joint_angles(self):
        return np.array([self._limb.joint_angle(j) for j in self.joint_names])

    def get_joint_angles_velocity(self):
        return np.array([self._limb.joint_velocity(j)
                         for j in self.joint_names])

    def get_state(self):
        return (self.get_joint_angles(), self.get_joint_angles_velocity(),
                self.get_cartesian_pose())

    def get_cartesian_pose(self):
        return self._ep_handler.get_eep()

    def quat_2_euler(self, quat):
        """(w,x,y,z) quaternion -> (yaw+pi, pitch, roll); the +pi matches the
        reference's gripper-frame convention."""
        from scipy.spatial.transform import Rotation
        yaw, pitch, roll = Rotation.from_quat(
            np.roll(np.asarray(quat), -1)).as_euler('ZYX')
        return np.array([yaw + np.pi, pitch, roll])

    def euler_2_quat(self, yaw=np.pi / 2, pitch=0.0, roll=np.pi):
        from scipy.spatial.transform import Rotation
        yaw = np.pi - yaw
        quat_xyzw = Rotation.from_euler('ZYX', [yaw, pitch, roll]).as_quat()
        return np.roll(quat_xyzw, 1)   # -> (w, x, y, z)
