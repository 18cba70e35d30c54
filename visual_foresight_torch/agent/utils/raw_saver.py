"""Raw pkl+png trajectory writer (reference ``visual_mpc/agent/utils/raw_saver.py``).

Layout: ``<save_dir>/raw/traj_group{N}/traj{i}/images{cam}/im_{t}.png`` plus
``agent_data.pkl`` / ``obs_dict.pkl`` / ``policy_out.pkl``.  These folders are
what BenchmarkAgent later loads as start/goal configurations.  OpenCV is
imported where the frames are written.
"""

import os
import pickle as pkl
import shutil


class RawSaver:
    def __init__(self, save_dir, ngroup=1000, subdir='raw'):
        self.save_dir = save_dir
        self.ngroup = ngroup
        # '' places groups directly under save_dir (sim collection layout);
        # the default 'raw' matches the robot/benchmark layout
        self.subdir = subdir

    def save_traj(self, itr, agent_data=None, obs_dict=None, policy_outputs=None):
        igrp = itr // self.ngroup
        group_folder = os.path.join(self.save_dir, self.subdir,
                                    'traj_group{}'.format(igrp))
        os.makedirs(group_folder, exist_ok=True)

        traj_folder = os.path.join(group_folder, 'traj{}'.format(itr))
        if os.path.exists(traj_folder):
            print('trajectory folder {} already exists, deleting'.format(traj_folder))
            shutil.rmtree(traj_folder)
        os.makedirs(traj_folder)
        print('writing: ', traj_folder)

        if obs_dict is not None and 'images' in obs_dict:
            import cv2
            images = obs_dict.pop('images')
            T, n_cams = images.shape[:2]
            for i in range(n_cams):
                os.mkdir(os.path.join(traj_folder, 'images{}'.format(i)))
            for t in range(T):
                for i in range(n_cams):
                    cv2.imwrite('{}/images{}/im_{}.png'.format(traj_folder, i, t),
                                images[t, i, :, :, ::-1])

        for name, data in (('agent_data', agent_data), ('obs_dict', obs_dict),
                           ('policy_out', policy_outputs)):
            if data is not None:
                with open('{}/{}.pkl'.format(traj_folder, name), 'wb') as f:
                    pkl.dump(data, f)
