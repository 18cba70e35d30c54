"""Sawyer electric parallel gripper via intera
(reference ``grippers/sawyer/default_sawyer_gripper.py``).

The port's copy of ``visual_foresight_tpu/envs/robot_envs/grippers/sawyer/de
fault_sawyer_gripper.py``."""

from ..gripper import GripperInterface


class SawyerDefaultGripper(GripperInterface):
    def __init__(self):
        import intera_interface
        self._gripper = intera_interface.Gripper('right_gripper')
        self._gripper.calibrate()

    @property
    def GRIPPER_CLOSE(self):
        return self._gripper.MIN_POSITION

    @property
    def GRIPPER_OPEN(self):
        return self._gripper.MAX_POSITION

    def get_gripper_state(self, integrate_force=False):
        force = self._gripper.get_force() if integrate_force else None
        return self._gripper.get_position(), force

    def get_gripper_limits(self):
        return self.GRIPPER_CLOSE, self.GRIPPER_OPEN

    def set_gripper(self, position, wait=False):
        self._gripper.set_position(position)

    def set_gripper_speed(self, new_speed):
        self._gripper.set_velocity(new_speed)
