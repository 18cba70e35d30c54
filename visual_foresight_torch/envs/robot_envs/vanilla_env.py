"""Raw 5-dim delta action space (reference ``robot_envs/vanilla_env.py``).

The port's copy of ``visual_foresight_tpu/envs/robot_envs/vanilla_env.py``."""

import copy

from .base_env import _QPOS_DIM, BaseRobotEnv


class VanillaEnv(BaseRobotEnv):
    ACTION_DIM = STATE_DIM = _QPOS_DIM

    def __init__(self, env_params, _=None):
        self._hyper = copy.deepcopy(env_params)
        BaseRobotEnv.__init__(self, env_params)

    def _next_qpos(self, action):
        assert action.shape[0] == self._base_adim, 'action must be 5-dim'
        return self._previous_target_qpos * self.mode_rel + action
