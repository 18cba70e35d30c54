"""Gripper null-object interface (reference ``grippers/gripper.py``).

Controllers hold one of these; robots without a gripper use the defaults.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/grippers/gripper.py``."""


class GripperInterface:
    def __init__(self):
        pass

    @property
    def GRIPPER_CLOSE(self):
        return 0.0

    @property
    def GRIPPER_OPEN(self):
        return 1.0

    def get_gripper_state(self, integrate_force=False):
        """:return: (joint_position, force_reading or None)"""
        return self.GRIPPER_OPEN, None

    def get_gripper_limits(self):
        return self.GRIPPER_CLOSE, self.GRIPPER_OPEN

    def set_gripper(self, position, wait=False):
        pass

    def open_gripper(self, wait=False):
        self.set_gripper(self.GRIPPER_OPEN, wait=wait)

    def close_gripper(self, wait=False):
        self.set_gripper(self.GRIPPER_CLOSE, wait=wait)

    def set_gripper_speed(self, new_speed):
        pass
