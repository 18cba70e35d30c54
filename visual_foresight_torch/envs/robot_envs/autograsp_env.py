"""4-dim autograsp action space on real robots
(reference ``robot_envs/autograsp_env.py``).

The port's copy of
``visual_foresight_tpu/envs/robot_envs/autograsp_env.py``."""

import copy
import logging

import numpy as np

from visual_foresight_torch.envs.util.action_util import autograsp_dynamics
from .base_env import _QPOS_DIM, BaseRobotEnv


class AutograspEnv(BaseRobotEnv):
    ACTION_DIM, STATE_DIM = 4, _QPOS_DIM

    def __init__(self, env_params, _=None):
        assert 'mode_rel' not in env_params, 'autograsp sets mode_rel'
        self._hyper = copy.deepcopy(env_params)
        BaseRobotEnv.__init__(self, self._hyper)

    def _init_dynamics(self):
        self._gripper_closed = False
        self._prev_touch = False

    def _default_hparams(self):
        default_dict = {
            'zthresh': 0.15,
            'gripper_joint_grasp_min': 0.0,
            'gripper_joint_thresh': -1.,   # < 0 disables the joint check
            'reopen': True,
            'robot_upside_down': False,
        }
        parent_params = BaseRobotEnv._default_hparams(self)
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    def _next_qpos(self, action):
        assert action.shape[0] == 4
        norm_gripper_z = (self._previous_target_qpos[2] - self._low_bound[2]) \
            / (self._high_bound[2] - self._low_bound[2])
        if self._hp.robot_upside_down:
            norm_gripper_z = 1 - norm_gripper_z

        joint_test = self._last_obs['state'][-1] > \
            self._hp.gripper_joint_grasp_min and \
            abs(self._last_obs['state'][-1]) < self._hp.gripper_joint_thresh
        touch_test = joint_test or \
            np.amax(self._last_obs.get('finger_sensors', 0)) > 0
        logging.getLogger('robot_logger').debug(
            'joint %s test %s', self._last_obs['state'][-1], joint_test)

        target, self._gripper_closed = autograsp_dynamics(
            self._previous_target_qpos, action, self._gripper_closed,
            norm_gripper_z, self._hp.zthresh, self._hp.reopen,
            touch_test or self._prev_touch,
            self._low_bound[-1], self._high_bound[-1])
        self._prev_touch = touch_test
        return target
