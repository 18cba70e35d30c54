"""Autograsp CEM sampler (reference ``samplers/autograsp_sampler.py``).

Samples xyz/theta motion with the Gaussian sampler and derives the gripper
dimension from cumulative-z threshold logic (+ optional reopen, deviation
noise, and close-probability resampling of the gripper on refit).

Pairing contract: the derived gripper command becomes the TRAILING action
dim, so this sampler is for explicit-gripper action spaces (e.g. the 5-dim
``VanillaEnv`` family) where the env consumes that dim as the grip command.
Auto-latching envs (``AutograspCartgripperEnv`` / robot ``AutograspEnv``,
4-dim xyz/theta commands, gripper latched by the env) take the default
Gaussian sampler over all commanded dims — appending a +/-1 "grip" value
there would feed it into the theta dim.

The port's own copy of ``visual_foresight_tpu/policy/cem_controllers/
samplers/autograsp_sampler.py``, drawing from the sampler's RandomState.
"""

import numpy as np

from .gaussian_sampler import GaussianCEMSampler


class AutograspSampler(GaussianCEMSampler):
    def __init__(self, hp, adim, sdim, **kwargs):
        super().__init__(hp, adim - 1, sdim, **kwargs)

    @staticmethod
    def get_default_hparams():
        parent = GaussianCEMSampler.get_default_hparams()
        parent.update({
            'deviation_prob': 0,
            'reopen': False,
            'action_norm_factor': 1.0,     # 100 / (high_z - low_z)
            'z_thresh': 0.15,
            'gripper_close_cmd': 1,
            'gripper_open_cmd': -1,
            'no_refit': True,
        })
        return parent

    def sample_initial_actions(self, t, nsamples, current_state):
        self._current_state = current_state
        base = super().sample_initial_actions(t, nsamples, current_state)
        return self._sample_gripper(base, base.shape[0])

    def sample_next_actions(self, n_samples, best_actions, scores):
        default_actions = super().sample_next_actions(
            n_samples, best_actions[:, :, :-1], scores)
        if self._hp.no_refit:
            return self._sample_gripper(default_actions,
                                        default_actions.shape[0])

        n = default_actions.shape[0]
        grip_act = np.zeros((n, default_actions.shape[1], 1), np.float32)
        close_prob = np.mean(
            (best_actions[:, :, -1] == self._hp.gripper_close_cmd)
            .astype(np.float32), axis=0)
        for t in range(default_actions.shape[1]):
            cmd_t = self._rng.uniform(size=n) < close_prob[t]
            grip_act[:, t, 0] = cmd_t * self._hp.gripper_close_cmd + \
                np.logical_not(cmd_t) * self._hp.gripper_open_cmd
        return np.concatenate((default_actions, grip_act), axis=-1)

    def _sample_gripper(self, default_samples, nsamples):
        grip_actions = np.zeros((nsamples, default_samples.shape[1], 1))
        for b in range(nsamples):
            close_mask = np.cumsum(
                default_samples[b, :, 2] * self._hp.action_norm_factor) + \
                self._current_state[2] < self._hp.z_thresh

            if not self._hp.reopen:
                nz = close_mask.nonzero()[0]
                if len(nz):
                    close_mask[nz[0]:] = True

            if self._hp.deviation_prob:
                flip = self._rng.uniform(size=close_mask.shape[0]) < \
                    self._hp.deviation_prob
                close_mask = np.logical_xor(close_mask, flip)

            open_mask = np.logical_not(close_mask)
            grip_actions[b, :, 0] = open_mask * self._hp.gripper_open_cmd + \
                close_mask * self._hp.gripper_close_cmd
        return np.concatenate((default_samples, grip_actions), axis=-1)
