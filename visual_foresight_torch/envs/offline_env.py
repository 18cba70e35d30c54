"""Offline replay env (reference ``envs/offline_env.py`` — which was an
incomplete stub; this version is functional).

Replays logged observations from a raw trajectory folder, emulating a robot
env for hermetic pipeline testing and controller debugging.  OpenCV is
imported where a trajectory's frames are read.

The port's own copy of ``visual_foresight_tpu/envs/offline_env.py``.
"""

import glob
import os
import pickle as pkl

import numpy as np

from visual_foresight_torch.envs.base_env import BaseEnv


class OfflineEnv(BaseEnv):
    def __init__(self, env_params, reset_state=None):
        self._hp = self._default_hparams()
        for name, value in env_params.items():
            if name == 'robot_name':
                continue
            self._hp.set_hparam(name, value)
        self._traj_folders = sorted(glob.glob(os.path.join(
            self._hp.data_dir, 'traj_group*', 'traj*')))
        if not self._traj_folders:
            raise ValueError('no trajectories under {}'.format(
                self._hp.data_dir))
        self._traj_idx = -1
        self._t = 0

    def _default_hparams(self):
        parent = super()._default_hparams()
        parent.add_hparam('data_dir', '')
        parent.add_hparam('adim', 3)
        parent.add_hparam('sdim', 3)
        parent.add_hparam('ncam', 1)
        return parent

    def _load(self, folder):
        import cv2
        with open(os.path.join(folder, 'obs_dict.pkl'), 'rb') as f:
            self._obs_dict = pkl.load(f)
        frame_dirs = sorted(glob.glob(os.path.join(folder, 'images*')))
        frames = []
        t = 0
        while True:
            cams = []
            for d in frame_dirs:
                hit = None
                for ext in ('png', 'jpg'):
                    p = os.path.join(d, 'im_{}.{}'.format(t, ext))
                    if os.path.isfile(p):
                        hit = cv2.imread(p)[:, :, ::-1]
                        break
                if hit is None:
                    cams = None
                    break
                cams.append(hit)
            if cams is None:
                break
            frames.append(np.stack(cams))
            t += 1
        self._frames = np.stack(frames) if frames else None
        self._T = t

    def reset(self):
        self._traj_idx = (self._traj_idx + 1) % len(self._traj_folders)
        self._load(self._traj_folders[self._traj_idx])
        self._t = 0
        return self._obs_at(0), None

    def _obs_at(self, t):
        obs = {}
        for k, v in self._obs_dict.items():
            if isinstance(v, np.ndarray) and v.ndim >= 1 and \
                    v.shape[0] > t:
                obs[k] = v[t]
        if self._frames is not None:
            obs['images'] = self._frames[min(t, self._T - 1)]
        return obs

    def step(self, action):
        self._t = min(self._t + 1, self._T - 1)
        return self._obs_at(self._t)

    def current_obs(self):
        return self._obs_at(self._t)

    def valid_rollout(self):
        return True

    @property
    def adim(self):
        return self._hp.adim

    @property
    def sdim(self):
        return self._hp.sdim

    @property
    def ncam(self):
        return self._hp.ncam

    @staticmethod
    def default_ncam():
        return 1


class OfflineSawyerEnv(OfflineEnv):
    """Name-compatible alias (reference ``envs/offline_env.py:4``)."""
