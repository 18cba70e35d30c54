"""Agent-side HDF5 trajectory saver (reference ``agent/utils/hdf5_saver.py``,
which imported a missing external ``recursive_planning`` package; this version
is self-contained on :class:`HDF5SaverBase`).

Pads trajectories to ``max_num_actions`` with a 0/1 pad mask and writes
train/val/test-bucketed h5 groups.

The port's own copy of ``visual_foresight_tpu/agent/utils/hdf5_saver.py``.
"""

import numpy as np

from .record_saver import HDF5SaverBase


def pad_traj_timesteps(traj, max_num_actions):
    """Zero-pad images (to max_num_actions+1 frames) and actions."""
    im_shape = traj['images'].shape
    ac_shape = traj['actions'].shape

    if ac_shape[0] < max_num_actions:
        zeros = np.zeros(
            [max_num_actions - im_shape[0] + 1] + list(im_shape[1:]),
            dtype=np.uint8)
        traj['images'] = np.concatenate([traj['images'], zeros])
        if len(ac_shape) > 1:
            zeros = np.zeros([max_num_actions - ac_shape[0], ac_shape[1]])
        else:
            zeros = np.zeros([max_num_actions - ac_shape[0]])
        traj['actions'] = np.concatenate([traj['actions'], zeros])

    assert traj['images'].shape[0] == max_num_actions + 1
    assert traj['actions'].shape[0] == max_num_actions
    return traj


def get_pad_mask(action_len, max_num_actions):
    """1 where real data, 0 where padding; length max_num_actions+1."""
    if action_len < max_num_actions:
        mask = np.concatenate([np.ones(action_len + 1),
                               np.zeros(max_num_actions - action_len)])
    elif action_len == max_num_actions:
        mask = np.ones(max_num_actions + 1)
    else:
        raise ValueError('trajectory longer than max_num_actions')
    assert mask.shape[0] == max_num_actions + 1
    return mask


class HDF5Saver(HDF5SaverBase):
    def __init__(self, save_dir, envparams, agentparams, traj_per_file,
                 offset=0, split=(0.90, 0.05, 0.05), split_train_val_test=True):
        if isinstance(envparams, dict) and 'max_num_actions' in envparams:
            self.max_num_actions = envparams['max_num_actions']
        elif hasattr(envparams, 'max_num_actions'):
            self.max_num_actions = envparams.max_num_actions
        elif isinstance(agentparams, dict):
            self.max_num_actions = agentparams['T']
        else:
            self.max_num_actions = agentparams.T
        super().__init__(save_dir, traj_per_file, offset, split,
                         split_train_val_test)

    def make_traj(self, obs, policy_out):
        traj = {
            'images': obs['images'],
            'states': obs['state'],
            'actions': np.stack([p['actions'] for p in policy_out], 0),
        }
        traj['pad_mask'] = get_pad_mask(traj['actions'].shape[0],
                                        self.max_num_actions)
        return pad_traj_timesteps(traj, self.max_num_actions)

    def save_traj(self, itr, agent_data, obs, policy_out):
        self._save_traj(self.make_traj(obs, policy_out))
