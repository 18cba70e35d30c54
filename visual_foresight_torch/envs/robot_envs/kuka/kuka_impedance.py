"""Kuka iiwa impedance controller (reference ``robot_envs/kuka/kuka_impedance.py``
+ ``kuka_interface.py``).  Requires ROS + iiwa_stack at runtime.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/kuka/kuka_impedance.py``."""

import numpy as np

from visual_foresight_torch.envs.util.interpolation import CSpline
from ..robot_controller_interface import RobotController

NEUTRAL_JOINT_ANGLES = np.array([0.0, 0.6, 0.0, -1.2, 0.0, 0.8, 0.0])
N_JOINTS = 7


class KukaImpedanceController(RobotController):
    def __init__(self, robot_name='kuka', print_debug=False,
                 email_cred_file='', log_file='', control_rate=100,
                 gripper_attached='default'):
        super().__init__(robot_name, print_debug, email_cred_file, log_file,
                         control_rate, gripper_attached)
        import rospy
        from iiwa_msgs.msg import JointPosition
        from geometry_msgs.msg import PoseStamped
        from sensor_msgs.msg import JointState
        self._JointPosition = JointPosition
        self._PoseStamped = PoseStamped
        self._joint_state = None
        self._cart_state = None
        rospy.Subscriber('/iiwa/state/JointPosition', JointPosition,
                         self._ja_cb)
        rospy.Subscriber('/iiwa/state/CartesianPose', PoseStamped,
                         self._cart_cb)
        self._ja_pub = rospy.Publisher('/iiwa/command/JointPosition',
                                       JointPosition, queue_size=10)
        self._cart_pub = rospy.Publisher('/iiwa/command/CartesianPose',
                                         PoseStamped, queue_size=10)
        while self._joint_state is None or self._cart_state is None:
            rospy.sleep(0.05)

    def _ja_cb(self, msg):
        p = msg.position
        self._joint_state = np.array([p.a1, p.a2, p.a3, p.a4, p.a5, p.a6, p.a7])

    def _cart_cb(self, msg):
        p, o = msg.pose.position, msg.pose.orientation
        self._cart_state = np.array([p.x, p.y, p.z, o.w, o.x, o.y, o.z])

    def get_joint_angles(self):
        return self._joint_state.copy()

    def get_state(self):
        return self.get_joint_angles(), None, self.get_cartesian_pose()

    def get_cartesian_pose(self):
        return self._cart_state.copy()

    def move_to_ja(self, waypoints, duration=1.5):
        import rospy
        prev = self.get_joint_angles()
        spline = CSpline(np.array([prev] + list(waypoints)), duration)
        start = rospy.get_time()
        t = start
        while t - start < duration:
            pos = spline.get(t - start)[0]
            msg = self._JointPosition()
            (msg.position.a1, msg.position.a2, msg.position.a3,
             msg.position.a4, msg.position.a5, msg.position.a6,
             msg.position.a7) = pos
            self._ja_pub.publish(msg)
            self._rate.sleep()
            t = rospy.get_time()

    def move_to_eep(self, target_pose, duration=1.5):
        import rospy
        msg = self._PoseStamped()
        msg.header.stamp = rospy.Time.now()
        msg.header.frame_id = 'iiwa_link_0'
        msg.pose.position.x, msg.pose.position.y, msg.pose.position.z = \
            target_pose[:3]
        (msg.pose.orientation.w, msg.pose.orientation.x,
         msg.pose.orientation.y, msg.pose.orientation.z) = target_pose[3:]
        self._cart_pub.publish(msg)
        rospy.sleep(duration)

    def move_to_neutral(self, duration=2.0):
        self.move_to_ja([NEUTRAL_JOINT_ANGLES], duration)
