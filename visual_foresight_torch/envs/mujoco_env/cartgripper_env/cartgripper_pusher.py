"""4-DoF pusher cartgripper (x, y, z, theta — no gripper)
(reference ``cartgripper_env/cartgripper_pusher.py``).

The port's own copy of
``visual_foresight_tpu/envs/mujoco_env/cartgripper_env/cartgripper_pusher.py``.
"""

import numpy as np

from .base_cartgripper import BaseCartgripperEnv


class CartgripperPusherEnv(BaseCartgripperEnv):
    def __init__(self, env_params, reset_state=None):
        super().__init__(env_params, reset_state)
        self.low_bound = np.array([-0.5, -0.5, -0.08, -np.pi * 2])
        self.high_bound = np.array([0.5, 0.5, 0.15, np.pi * 2])
        self._adim, self._sdim = 4, 4
        self._base_adim, self._base_sdim = 4, 4
        self._n_joints = 4

    def _default_hparams(self):
        parent_params = super()._default_hparams()
        parent_params.set_hparam('filename', 'cartgripper_pusher.xml')
        parent_params.set_hparam('mode_rel', [True, True, True, True])
        return parent_params

    def get_armpos(self, object_pos):
        xpos0_base = super().get_armpos(object_pos)
        xpos0 = np.zeros(self._base_sdim)
        xpos0[:3] = xpos0_base[:3]
        xpos0[3] = np.random.uniform(-np.pi, np.pi)
        return xpos0

    def _init_dynamics(self):
        self._previous_target_qpos = self._data.qpos[:self._base_adim].copy()

    def _next_qpos(self, action):
        assert action.shape[0] == self._adim
        return self._previous_target_qpos * self.mode_rel + action

    def has_goal(self):
        return False
