"""5-DoF cartgripper (x, y, z, theta, grasp)
(reference ``visual_mpc/envs/mujoco_env/cartgripper_env/cartgripper_rot_grasp.py``)."""

import numpy as np

from .base_cartgripper import BaseCartgripperEnv


class CartgripperRotGraspEnv(BaseCartgripperEnv):
    """Cartgripper env with motion in x, y, z, rot, grasp."""

    def __init__(self, env_params, reset_state=None):
        super().__init__(env_params, reset_state)
        # ctrl bounds [x, y, z, theta, finger]; finger 0 = open, 0.1 = close
        self.low_bound = np.array([-0.5, -0.5, -0.08, -np.pi * 2, 0.])
        self.high_bound = np.array([0.5, 0.5, 0.15, np.pi * 2, 0.1])
        self._base_adim, self._base_sdim = 5, 6
        self._n_joints = 6
        self._gripper_dim = 4
        self._adim, self._sdim = 5, 5

    def _default_hparams(self):
        parent_params = super()._default_hparams()
        parent_params.set_hparam('filename', 'cartgripper_grasp.xml')
        return parent_params

    def get_armpos(self, object_pos):
        xpos0_true_dim = super().get_armpos(object_pos)
        xpos0 = np.zeros(self._base_sdim)
        xpos0[:3] = xpos0_true_dim[:3]
        xpos0[3] = np.random.uniform(-np.pi, np.pi)
        xpos0[4:6] = [0.0, 0.0]
        return xpos0

    def _init_dynamics(self):
        self._previous_target_qpos = np.concatenate(
            [self._data.qpos[:4].copy(), [0.0]])
        self._goal_reached = False

    def _next_qpos(self, action):
        assert action.shape[0] == self._adim
        grip_ctrl = self.high_bound[-1] if action[-1] > 0 else self.low_bound[-1]
        action = np.concatenate([action[:4], [grip_ctrl]])
        return self._previous_target_qpos * self.mode_rel + action

    def _snap_ctrl_to_qpos(self, qpos):
        return np.concatenate([qpos[:4], [0.0]])

    # -- benchmark task generation -------------------------------------------------
    def _move_arm(self):
        target_dx = np.random.uniform(-0.4, 0.4) - self._previous_target_qpos[0]
        target_dy = np.random.uniform(-0.4, 0.4) - self._previous_target_qpos[1]
        target_dz = np.random.uniform(0.1, self.high_bound[2]) - \
            self._previous_target_qpos[2]
        target_dtheta = np.random.uniform(-np.pi / 2, np.pi / 2) - \
            self._previous_target_qpos[3]
        target_qpos = self._next_qpos(
            np.array([target_dx, target_dy, target_dz, target_dtheta, -1]))
        target_qpos[-1] = self.low_bound[-1]
        BaseCartgripperEnv._step(self, target_qpos)

    def _move_objects(self):
        """Place a block between the fingers repeatedly until grasped."""
        i = np.random.choice(self.num_objects)
        wiggle = self._hp.maxlen
        done = False
        while not done:
            base = self._n_joints + i * 7
            target_z = self._previous_target_qpos[2] + 0.015 + \
                np.random.uniform(-wiggle, wiggle)
            self._data.qpos[base] = self._previous_target_qpos[0] + \
                np.random.uniform(-wiggle, wiggle)
            self._data.qpos[base + 1] = self._previous_target_qpos[1] + \
                np.random.uniform(-wiggle, wiggle)
            self._data.qpos[base + 2] = target_z
            self._sim_step()

            target_cmd = self._previous_target_qpos.copy()
            target_cmd[-1] = self.high_bound[-1]
            for _ in range(self.substeps):
                self._data.qpos[base + 2] = target_z
                self._data.ctrl[:] = target_cmd
                self._sim_step()
            for _ in range(self.substeps * 5):
                self._sim_step()

            if self._data.qpos[base + 2] > 0.05:
                done = True
            else:
                target_cmd[-1] = self.low_bound[-1]
                for _ in range(self.substeps):
                    self._data.ctrl[:] = target_cmd
                    self._sim_step()

    def generate_task(self):
        self._move_arm()
        self._move_objects()

    def has_goal(self):
        return True

    def goal_reached(self):
        return self._goal_reached
