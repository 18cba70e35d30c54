"""Random data-collection policies
(reference ``visual_mpc/policy/random/gaussian.py``).

``GaussianPolicy`` samples one full plan from a diagonal-variance Gaussian at
t=0, clips and repeat-expands it, then plays it back.  The AG-epsilon variant
adds autograsp gripper logic with epsilon-greedy flips for grasp exploration.

The port's own copy of ``visual_foresight_tpu/policy/random/gaussian.py``.
"""

import numpy as np

from visual_foresight_torch.envs.util.action_util import autograsp_grip_logic
from visual_foresight_torch.policy.policy import Policy
from visual_foresight_torch.policy.utils.controller_utils import (
    construct_initial_sigma, truncate_movement)


class GaussianPolicy(Policy):
    """Random policy."""

    def __init__(self, agentparams, policyparams, gpu_id=0, ngpu=1):
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)
        self.agentparams = agentparams
        self.adim = agentparams['adim']

    # public so config files can consult the defaults without instantiating
    # (identical-to-default overrides are rejected by _override_defaults)
    DEFAULT_HPARAMS = {
        'nactions': 5,
        'repeat': 3,
        'action_bound': True,
        'action_order': None,
        'initial_std': 0.05,
        'initial_std_lift': 0.15,
        'initial_std_rot': np.pi / 18,
        'initial_std_grasp': 2.,
        'type': None,
        'discrete_gripper': None,
    }

    def _default_hparams(self):
        parent_params = super()._default_hparams()
        for k, v in self.DEFAULT_HPARAMS.items():
            parent_params.add_hparam(k, v)
        return parent_params

    def act(self, t):
        assert self.agentparams['T'] == self._hp.nactions * self._hp.repeat
        if t == 0:
            mean = np.zeros(self.adim * self._hp.nactions)
            sigma = construct_initial_sigma(self._hp, self.adim)
            self.actions = np.random.multivariate_normal(mean, sigma).reshape(
                self._hp.nactions, -1)
            self.process_actions()
        return {'actions': self.actions[t, :self.adim]}

    def process_actions(self):
        if self.actions.ndim == 2:
            self.actions = self._process(self.actions)
        elif self.actions.ndim == 3:
            self.actions = np.stack([self._process(a) for a in self.actions], axis=0)
        else:
            raise ValueError('actions must be rank 2 or 3')

    def _process(self, actions):
        if self._hp.discrete_gripper is not None:
            actions = discretize_gripper(actions, self._hp.discrete_gripper)
        if self._hp.action_bound:
            actions = truncate_movement(actions, self._hp)
        return np.repeat(actions, self._hp.repeat, axis=0)

    def finish(self):
        pass


def discretize_gripper(actions, gripper_ind):
    assert actions.ndim == 2
    actions[:, gripper_ind] = np.where(actions[:, gripper_ind] >= 0, 1.0, -1.0)
    return actions


class GaussianAGEpsilonPolicy(GaussianPolicy):
    """Gaussian motion + autograsp gripper with epsilon-greedy flips."""

    def _default_hparams(self):
        default_dict = {
            'p_epsilon': 0.15,
            'zthresh': 0.15,
            'gripper_joint_thresh': -1.,
            'reopen': True,
            'grip_cmds': [1.0, -1.0],
        }
        parent_params = super()._default_hparams()
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    def act(self, t, state, finger_sensors):
        parent_action = super().act(t)['actions']

        if t == 0:
            self._last_grip = None
            self._prev_touch = False

        if t % self._hp.repeat == 0:
            joint_test = state[-1, -1] > 0 and \
                abs(state[-1, -1]) < self._hp.gripper_joint_thresh
            touch_test = joint_test or np.amax(finger_sensors[-1]) > 0
            self._last_grip = autograsp_grip_logic(
                state[-1, 2], self._hp.zthresh, self._last_grip,
                self._hp.reopen, touch_test or self._prev_touch)
            self._prev_touch = touch_test

        def bool_cast(x):
            return self._hp.grip_cmds[0] if x else self._hp.grip_cmds[1]

        if np.random.uniform() < self._hp.p_epsilon:
            grip_cmd = bool_cast(not self._last_grip)
        else:
            grip_cmd = bool_cast(self._last_grip)

        parent_action[-1] = grip_cmd
        return {'actions': parent_action}
