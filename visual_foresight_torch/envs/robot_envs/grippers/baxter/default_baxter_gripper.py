"""Baxter electric gripper (reference ``grippers/baxter/default_baxter_gripper.py``).

The port's copy of ``visual_foresight_tpu/envs/robot_envs/grippers/baxter/de
fault_baxter_gripper.py``."""

from ..gripper import GripperInterface


class BaxterDefaultGripper(GripperInterface):
    def __init__(self, limb='right'):
        import baxter_interface
        self._gripper = baxter_interface.Gripper(limb)
        self._gripper.calibrate()

    @property
    def GRIPPER_CLOSE(self):
        return 0.0

    @property
    def GRIPPER_OPEN(self):
        return 100.0

    def get_gripper_state(self, integrate_force=False):
        force = self._gripper.force() if integrate_force else None
        return self._gripper.position(), force

    def get_gripper_limits(self):
        return self.GRIPPER_CLOSE, self.GRIPPER_OPEN

    def set_gripper(self, position, wait=False):
        self._gripper.command_position(position, block=wait)

    def set_gripper_speed(self, new_speed):
        self._gripper.set_velocity(new_speed)
