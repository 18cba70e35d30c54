"""Staged random towel-fold primitive
(reference ``policy/random/random_fold_policy.py``).

Five stages — move to pick point, descend, lift, move to drop point, descend —
with per-stage Gaussian action noise and geometric stage durations.

The port's own copy of
``visual_foresight_tpu/policy/random/random_fold_policy.py``.
"""

import copy

import numpy as np

from visual_foresight_torch.policy.policy import Policy
from visual_foresight_torch.policy.utils.controller_utils import truncate_movement


def round_up(val, round_to):
    return val + (-val % round_to)


class RandomFoldPolicy(Policy):
    def __init__(self, agent_params, policyparams, gpu_id=0, ngpu=1):
        assert agent_params['adim'] == 4, 'action dimension must be 4'
        self._adim, self._T = agent_params['adim'], agent_params['T']
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)
        self.agent_params = agent_params
        self._swap_times, self._stage, self._ctr = [], 0, 0
        self._last_action = None
        self._pick_point, self._drop_point = None, None

    def _default_hparams(self):
        default_dict = {
            'repeat': 3,
            'action_bound': False,
            'action_order': [None],
            'switch_prob': 0.25,
            'initial_std': 0.005,
            'initial_std_lift': 0.05,
            'initial_std_rot': np.pi / 18,
            'max_z_shift': 1. / 3,
            'min_dist': 0.8,
            'pick_timer': 3,
        }
        parent_params = super()._default_hparams()
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    def _override_defaults(self, policyparams):
        assert policyparams.get('repeat', 3) >= 1, 'repeat must be >= 1'
        return super()._override_defaults(policyparams)

    def _is_timer_set(self):
        return self._ctr > 0

    def _tick(self, ret_val):
        self._ctr -= 1
        if self._ctr == 0:
            self._stage += 1
        if self._hp.action_bound:
            ret_val['actions'] = truncate_movement(
                ret_val['actions'][None], self._hp)[0]
        return ret_val

    def _set_timer(self, countdown):
        self._ctr = countdown

    def _stage_action(self, mean, stds):
        action = np.random.multivariate_normal(mean, np.diag(stds))
        if self._hp.max_z_shift > 0:
            action[2] = np.clip(action[2], -self._hp.max_z_shift,
                                self._hp.max_z_shift)
        return action

    def act(self, t, state):
        if t == 0:
            action_time = round_up(self._hp.pick_timer, self._hp.repeat)
            move_time1 = self._T + 1
            while move_time1 > self._T - 3 * action_time - self._hp.repeat:
                move_time1 = round_up(
                    np.random.geometric(self._hp.switch_prob), self._hp.repeat)
            move_time2 = self._T - 3 * action_time - move_time1

            pick_point, drop_point = np.zeros(2), np.zeros(2)
            while np.linalg.norm(pick_point - drop_point) < self._hp.min_dist:
                pick_point = np.random.uniform(size=2)
                drop_point = np.random.uniform(size=2)
            self._pick_point, self._drop_point = pick_point, drop_point
            self._swap_times = [move_time1, action_time, action_time,
                                move_time2, action_time]
            self._stage, self._ctr = 0, 0

        if not self._is_timer_set():
            self._set_timer(self._swap_times[self._stage])

        xyz_std, rot_std = self._hp.initial_std, self._hp.initial_std_rot
        if self._stage in (0, 3):
            if t % self._hp.repeat == 0:
                mean = np.zeros(self._adim)
                dest = self._pick_point
                if self._stage > 0:
                    dest = self._drop_point
                    rot_std /= 5.
                mean[0:2] = (dest - state[-1, :2]) / self._ctr
                if state[-1, 2] < 0.5:
                    mean[2] = 1      # bias upward, avoid dragging the towel
                elif self._stage > 0:
                    mean[2] = 0.1
                self._last_action = self._stage_action(
                    mean, [xyz_std, xyz_std, self._hp.initial_std_lift,
                           rot_std])
            return self._tick({'actions': copy.deepcopy(self._last_action)})
        elif self._stage in (1, 4):
            if t % self._hp.repeat == 0:
                self._last_action = self._stage_action(
                    np.array([0., 0., -1, 0]),
                    [xyz_std / 5., xyz_std / 5.,
                     self._hp.initial_std_lift / 2., rot_std / 10.])
            return self._tick({'actions': copy.deepcopy(self._last_action)})
        elif self._stage == 2:
            if t % self._hp.repeat == 0:
                self._last_action = self._stage_action(
                    np.array([0., 0., 1, 0]),
                    [xyz_std / 10., xyz_std / 10.,
                     self._hp.initial_std_lift / 2., rot_std / 10.])
            return self._tick({'actions': copy.deepcopy(self._last_action)})
        raise ValueError('stage {} not defined'.format(self._stage))
