"""Kuka iiwa gripper over ROS command topics
(reference ``grippers/kuka/default_kuka_gripper.py``).

The port's copy of ``visual_foresight_tpu/envs/robot_envs/grippers/kuka/defa
ult_kuka_gripper.py``."""

from ..gripper import GripperInterface


class KukaDefaultGripper(GripperInterface):
    def __init__(self):
        import rospy
        from std_msgs.msg import Float64
        self._Float64 = Float64
        self._pub = rospy.Publisher('/iiwa/gripper_command', Float64,
                                    queue_size=5)
        self._position = 1.0

    @property
    def GRIPPER_CLOSE(self):
        return 0.0

    @property
    def GRIPPER_OPEN(self):
        return 1.0

    def get_gripper_state(self, integrate_force=False):
        return self._position, None

    def get_gripper_limits(self):
        return self.GRIPPER_CLOSE, self.GRIPPER_OPEN

    def set_gripper(self, position, wait=False):
        self._position = float(position)
        self._pub.publish(self._Float64(self._position))
