"""Franka impedance controller (reference ``robot_envs/franka/franka_impedance.py``).

Cartesian impedance interface over franka_ros topics; requires ROS + franka
stack at runtime.  Unlike the reference (whose franka env is
cartesian-only), ``move_to_ja`` is implemented: joint waypoints are splined
and published as a ``trajectory_msgs/JointTrajectory`` to the position
trajectory controller when it is available, else mapped through the panda
FK chain and streamed as equilibrium poses to the impedance controller.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/franka/franka_impedance.py``."""

import numpy as np

from visual_foresight_torch.envs.util.interpolation import CSpline
from ..robot_controller_interface import RobotController

NEUTRAL_JOINT_ANGLES = np.array([0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785])
N_JOINTS = 7


def joint_trajectory_samples(start, waypoints, duration, rate):
    """Spline (start + waypoints) into per-tick joint targets.

    :param start: (7,) current joint angles
    :param waypoints: list of (7,) target joint vectors
    :return: (ticks, 7) sample table plus the per-tick times (seconds)
    """
    spline = CSpline(np.array([np.asarray(start)] +
                              [np.asarray(w) for w in waypoints]), duration)
    ticks = max(int(duration * rate), 2)
    times = np.linspace(duration / ticks, duration, ticks)
    return np.stack([spline.get(t)[0] for t in times]), times


class FrankaImpedanceController(RobotController):
    def __init__(self, robot_name='franka', print_debug=False,
                 email_cred_file='', log_file='', control_rate=100,
                 gripper_attached='default'):
        super().__init__(robot_name, print_debug, email_cred_file, log_file,
                         control_rate, gripper_attached)
        import rospy
        from franka_msgs.msg import FrankaState
        from geometry_msgs.msg import PoseStamped
        self._PoseStamped = PoseStamped
        self._state = None
        rospy.Subscriber('/franka_state_controller/franka_states',
                         FrankaState, self._state_cb)
        self._pose_pub = rospy.Publisher(
            '/cartesian_impedance_controller/equilibrium_pose', PoseStamped,
            queue_size=10)
        while self._state is None:
            rospy.sleep(0.05)

    def _state_cb(self, msg):
        self._state = msg

    def get_joint_angles(self):
        return np.array(self._state.q)

    def get_state(self):
        return (np.array(self._state.q), np.array(self._state.dq),
                self.get_cartesian_pose())

    def get_cartesian_pose(self):
        from scipy.spatial.transform import Rotation
        T = np.array(self._state.O_T_EE).reshape(4, 4).T
        quat_xyzw = Rotation.from_matrix(T[:3, :3]).as_quat()
        return np.concatenate([T[:3, 3], np.roll(quat_xyzw, 1)])

    def move_to_eep(self, target_pose, duration=1.5):
        """Stream interpolated equilibrium poses to the impedance controller."""
        import rospy
        p1 = self.get_cartesian_pose()
        steps = max(int(duration * self._control_rate_hz), 2)
        spline = CSpline(np.array([p1[:3], target_pose[:3]]), duration)
        for i in range(steps):
            t = duration * (i + 1) / steps
            xyz = spline.get(t)[0]
            msg = self._PoseStamped()
            msg.header.stamp = rospy.Time.now()
            msg.header.frame_id = 'panda_link0'
            msg.pose.position.x, msg.pose.position.y, msg.pose.position.z = xyz
            msg.pose.orientation.w, msg.pose.orientation.x, \
                msg.pose.orientation.y, msg.pose.orientation.z = target_pose[3:]
            self._pose_pub.publish(msg)
            self._rate.sleep()

    def move_to_ja(self, waypoints, duration=1.5):
        """Joint-space move: JointTrajectory when the position trajectory
        controller is loaded, else FK-mapped equilibrium-pose streaming."""
        import rospy
        samples, times = joint_trajectory_samples(
            self.get_joint_angles(), waypoints, duration,
            self._control_rate_hz)
        try:
            from trajectory_msgs.msg import JointTrajectory, \
                JointTrajectoryPoint
            if not hasattr(self, '_ja_pub'):
                self._ja_pub = rospy.Publisher(
                    '/position_joint_trajectory_controller/command',
                    JointTrajectory, queue_size=1)
            msg = JointTrajectory()
            msg.joint_names = ['panda_joint{}'.format(i + 1)
                               for i in range(N_JOINTS)]
            for q, t in zip(samples, times):
                pt = JointTrajectoryPoint()
                pt.positions = list(q)
                pt.time_from_start = rospy.Duration(float(t))
                msg.points.append(pt)
            self._ja_pub.publish(msg)
            rospy.sleep(duration)
        except ImportError:
            # impedance-only install: chase the waypoints' FK poses
            from .inverse_kinematics import CHAIN
            for q in samples[::max(len(samples) // 10, 1)]:
                self.move_to_eep(CHAIN.fk_pose(q),
                                 duration=duration / 10.0)

    def move_to_neutral(self, duration=2.0):
        # neutral pose expressed cartesian for the impedance controller
        neutral = np.array([0.45, 0.0, 0.35, 0.0, 1.0, 0.0, 0.0])
        self.move_to_eep(neutral, duration)
