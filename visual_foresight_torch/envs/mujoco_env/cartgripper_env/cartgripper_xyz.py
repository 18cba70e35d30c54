"""Plain 3-DoF xyz cartgripper (no gripper)
(reference ``cartgripper_env/cartgripper_xyz.py``).

The port's own copy of
``visual_foresight_tpu/envs/mujoco_env/cartgripper_env/cartgripper_xyz.py``.
"""

import numpy as np

from .base_cartgripper import BaseCartgripperEnv


class CartgripperXYZEnv(BaseCartgripperEnv):
    def __init__(self, env_params, reset_state=None):
        super().__init__(env_params, reset_state)
        self._adim, self._sdim = 3, 3
        self._base_adim, self._base_sdim = 3, 3
        self._n_joints = 3

    def _init_dynamics(self):
        self._previous_target_qpos = self._data.qpos[:self._base_adim].copy()

    def _next_qpos(self, action):
        assert action.shape[0] == self._adim
        return self._previous_target_qpos * self.mode_rel + action

    def has_goal(self):
        return False

    def valid_rollout(self):
        return super().valid_rollout()
