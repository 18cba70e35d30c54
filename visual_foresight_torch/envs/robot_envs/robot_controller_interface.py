"""Robot controller base (reference ``robot_envs/robot_controller_interface.py``).

ROS node init, control-rate helpers, file+stream logging, optional email crash
alerts with log attachment, gripper delegation, quaternion helpers, and the
abstract motion API (``move_to_eep/move_to_ja/move_to_neutral``).

The port's copy of
``visual_foresight_tpu/envs/robot_envs/robot_controller_interface.py``.
"""

import logging
import os
import smtplib
import sys
import traceback
from email.mime.multipart import MIMEMultipart
from email.mime.text import MIMEText

import numpy as np

from .grippers.gripper import GripperInterface


def setup_robot_logger(log_file=None, print_debug=False):
    logger = logging.getLogger('robot_logger')
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)
    stream = logging.StreamHandler()
    stream.setLevel(logging.DEBUG if print_debug else logging.INFO)
    logger.addHandler(stream)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(
            '%(asctime)s %(levelname)s %(message)s'))
        logger.addHandler(fh)
    return logger


class EmailAlerter:
    """Crash/start email alerts (reference ``:56-113``): credentials file has
    two lines (login, password); alerts attach the tail of the log."""

    def __init__(self, cred_file, log_file=None, recipients=None):
        self._enabled = bool(cred_file) and os.path.isfile(cred_file)
        self._log_file = log_file
        if self._enabled:
            with open(cred_file) as f:
                lines = [l.strip() for l in f.readlines() if l.strip()]
            self._login, self._password = lines[0], lines[1]
            self._recipients = recipients or [self._login]

    def send(self, subject, body=''):
        if not self._enabled:
            return
        try:
            msg = MIMEMultipart()
            msg['Subject'] = subject
            msg['From'] = self._login
            msg['To'] = ', '.join(self._recipients)
            if self._log_file and os.path.isfile(self._log_file):
                with open(self._log_file) as f:
                    body += '\n\n--- log tail ---\n' + ''.join(
                        f.readlines()[-100:])
            msg.attach(MIMEText(body))
            with smtplib.SMTP_SSL('smtp.gmail.com', 465) as server:
                server.login(self._login, self._password)
                server.send_message(msg)
        except Exception as e:
            logging.getLogger('robot_logger').error(
                'email alert failed: {}'.format(e))


class RobotController:
    """Abstract controller; per-robot subclasses provide kinematics + motion."""

    def __init__(self, robot_name='robot', print_debug=False,
                 email_cred_file='', log_file='', control_rate=800,
                 gripper_attached='none'):
        self._robot_name = robot_name
        self._log = setup_robot_logger(log_file, print_debug)
        self._alerter = EmailAlerter(email_cred_file, log_file)
        self._control_rate_hz = control_rate

        self._init_ros_node()
        self._gripper = self._create_gripper(gripper_attached)
        self._alerter.send('robot {} controller started'.format(robot_name))
        sys.excepthook = self._crash_hook

    def _init_ros_node(self):
        try:
            import rospy
            rospy.init_node('visual_foresight_{}'.format(self._robot_name),
                            anonymous=True, disable_signals=True)
            self._rate = rospy.Rate(self._control_rate_hz)
            self._rospy = rospy
        except ImportError:
            self._rospy, self._rate = None, None
            self._log.warning('rospy not available — controller in dry mode')

    def _crash_hook(self, exc_type, exc_value, tb):
        self._log.error('controller crash: %s',
                        ''.join(traceback.format_exception(exc_type,
                                                           exc_value, tb)))
        self._alerter.send('robot {} CRASHED: {}'.format(
            self._robot_name, exc_value))
        sys.__excepthook__(exc_type, exc_value, tb)

    def _create_gripper(self, gripper_attached):
        if gripper_attached in ('none', None, ''):
            return GripperInterface()
        if gripper_attached == 'wsg-50':
            from .grippers.weiss.wsg50_gripper import WSG50Gripper
            return WSG50Gripper()
        if gripper_attached == 'default':
            return self._default_gripper()
        raise NotImplementedError(
            'unknown gripper {}'.format(gripper_attached))

    def _default_gripper(self):
        return GripperInterface()

    # -- gripper delegation --------------------------------------------------------
    def get_gripper_state(self, integrate_force=False):
        return self._gripper.get_gripper_state(integrate_force)

    def get_gripper_limits(self):
        return self._gripper.get_gripper_limits()

    def open_gripper(self, wait=False):
        self._gripper.open_gripper(wait)

    def close_gripper(self, wait=False):
        self._gripper.close_gripper(wait)

    # -- kinematic helpers -----------------------------------------------------------
    @staticmethod
    def quat_2_euler(quat):
        """(w,x,y,z) or (x,y,z,w)-agnostic yaw extraction is robot specific;
        default assumes (x,y,z,w) scipy convention and returns (yaw, pitch,
        roll)."""
        from scipy.spatial.transform import Rotation
        yaw, pitch, roll = Rotation.from_quat(quat).as_euler('ZYX')
        return np.array([yaw, pitch, roll])

    @staticmethod
    def euler_2_quat(yaw=0.0, pitch=np.pi, roll=0.0):
        from scipy.spatial.transform import Rotation
        return Rotation.from_euler('ZYX', [yaw, pitch, roll]).as_quat()

    # -- state / motion API (per-robot) -------------------------------------------------
    def get_state(self):
        """:return: (joint_angles, joint_velocities or None, cartesian eep)"""
        raise NotImplementedError

    def get_cartesian_pose(self):
        raise NotImplementedError

    def get_xyz_quat(self):
        eep = self.get_cartesian_pose()
        return eep[:3], eep[3:]

    def get_joint_angles(self):
        raise NotImplementedError

    def move_to_eep(self, target_pose, duration=1.5):
        """Move the end effector to (xyz + quat) over ``duration`` seconds."""
        raise NotImplementedError

    def move_to_ja(self, waypoints, duration=1.5):
        raise NotImplementedError

    def move_to_neutral(self, duration=2.0):
        raise NotImplementedError

    def redistribute_objects(self):
        """Periodic bin sweep to push objects back to the center."""
        self._log.info('redistribute_objects not implemented for {}'.format(
            type(self).__name__))
