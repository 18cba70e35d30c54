"""Raw (pkl + image dirs) -> GZIP TFRecord converter
(reference ``visual_mpc/utils/file_2_record.py``).

A pool of converter processes resizes frames (INTER_AREA) and optionally
infers gripper actions / goal_reached labels from states & finger sensors,
feeding the shared ``record_worker`` saver process.

CLI::

    python -m visual_foresight_torch.utils.file_2_record <save_dir> <paths> \
        <target_width> [--T N --split a b c --seperate --infer_gripper ...]

The port's own copy of ``visual_foresight_tpu/utils/file_2_record.py``.
"""

import argparse
import copy
import glob
import os
import pickle as pkl
import random
from multiprocessing import Manager, Process

import numpy as np

from visual_foresight_torch.agent.utils.traj_saver import record_worker


def _read_frame(traj, cam, t):
    import cv2
    for ext in ('jpg', 'png'):
        path = '{}/images{}/im_{}.{}'.format(traj, cam, t, ext)
        if os.path.isfile(path):
            return cv2.imread(path)[:, :, ::-1]
    raise FileNotFoundError('no frame for traj {} cam {} t {}'.format(
        traj, cam, t))


def save_worker(save_conf):
    import cv2
    (assigned_files, record_queue, T, target_width, seperate, infer_gripper,
     separate_views) = save_conf
    target_dim = None
    ncam = None
    for traj in assigned_files:
        if target_dim is None:
            ncam = len(glob.glob('{}/images*/'.format(traj)))
            img = _read_frame(traj, 0, 0)
            old_dim = img.shape[:2]
            resize_ratio = target_width / float(old_dim[1])
            target_dim = (target_width, int(old_dim[0] * resize_ratio))
            print('resizing to {}'.format(target_dim[::-1]))

        with open('{}/agent_data.pkl'.format(traj), 'rb') as f:
            agent_data = pkl.load(f)
        with open('{}/obs_dict.pkl'.format(traj), 'rb') as f:
            obs_dict = pkl.load(f)
        with open('{}/policy_out.pkl'.format(traj), 'rb') as f:
            policy_out = pkl.load(f)

        imgs = np.zeros((T, ncam, target_dim[1], target_dim[0], 3),
                        dtype=np.uint8)
        for t in range(T):
            for n in range(ncam):
                img = _read_frame(traj, n, t)
                if '_mirror' in traj and n == 0:
                    img = img[:, ::-1]
                imgs[t, n] = cv2.resize(img, target_dim,
                                        interpolation=cv2.INTER_AREA)
        obs_dict['images'] = imgs

        if infer_gripper:
            policy_shape = policy_out[0]['actions'].shape[0]
            assert policy_shape in (4, 5), 'invalid dims to infer gripper'
            if policy_shape == 4:
                # append a gripper action derived from the next state
                for i, p in enumerate(policy_out):
                    new_action = np.ones(5, dtype=p['actions'].dtype)
                    new_action[:-1] = p['actions']
                    if obs_dict['state'][i + 1, -1] <= -0.5:
                        new_action[-1] = -1
                    p['actions'] = new_action
            elif policy_shape == 5 and seperate and \
                    'goal_reached' not in agent_data:
                good = np.logical_and(obs_dict['state'][:-1, 2] >= 0.9,
                                      obs_dict['state'][:-1, -1] > -0.5)
                agent_data['goal_reached'] = bool(np.sum(np.logical_and(
                    np.abs(obs_dict['state'][:-1, -1]) < 0.97, good)) >= 2)

        if seperate and 'goal_reached' not in agent_data:
            state = obs_dict['state']
            finger_sensor = obs_dict['finger_sensors']
            good = np.logical_and(state[:-1, 2] >= 0.9, state[:-1, -1] > 0)
            agent_data['goal_reached'] = bool(np.sum(np.logical_and(
                finger_sensor[:-1, 0] > 0, good)) >= 2)

        if 'stats' in agent_data:   # stray key from benchmark runs
            agent_data.pop('stats')

        # trim obs histories to T (writers expect uniform length)
        for k in list(obs_dict.keys()):
            if isinstance(obs_dict[k], np.ndarray) and \
                    obs_dict[k].shape[:1] >= (T,):
                obs_dict[k] = obs_dict[k][:T + 1] if k != 'images' \
                    else obs_dict[k][:T]

        if separate_views:
            obs_images = obs_dict.pop('images')
            for n in range(ncam):
                a_n, o_n, p_n = [copy.deepcopy(x)
                                 for x in (agent_data, obs_dict, policy_out)]
                o_n['images'] = obs_images[:, n].reshape(
                    (T, 1, target_dim[1], target_dim[0], 3))
                record_queue.put((a_n, o_n, p_n))
        else:
            record_queue.put((agent_data, obs_dict, policy_out))


def main(cmd_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('save_dir', type=str)
    parser.add_argument('paths', type=str,
                        help='colon-separated raw data roots')
    parser.add_argument('target_width', type=int)
    parser.add_argument('--split', type=float, nargs='+',
                        default=[0.9, 0.05, 0.05])
    parser.add_argument('--T', type=int, default=30)
    parser.add_argument('--offset', type=int, default=0)
    parser.add_argument('--nworkers', type=int, default=4)
    parser.add_argument('--traj_per_file', type=int, default=16)
    parser.add_argument('--seperate', action='store_true', default=False,
                        help='split good/bad by goal_reached')
    parser.add_argument('--infer_gripper', action='store_true', default=False)
    parser.add_argument('--separate_views', action='store_true', default=False)
    args = parser.parse_args(cmd_args)

    trajs = []
    for path in args.paths.split(':'):
        trajs.extend(glob.glob('{}/traj_group*/traj*'.format(path)))
        trajs.extend(glob.glob('{}/raw/traj_group*/traj*'.format(path)))
    trajs = sorted(set(t for t in trajs if os.path.isdir(t)))
    random.shuffle(trajs)
    print('converting {} trajectories'.format(len(trajs)))
    if not trajs:
        return

    m = Manager()
    record_queue = m.Queue()
    saver_proc = Process(target=record_worker, args=(
        record_queue, args.save_dir, args.T, args.seperate,
        args.traj_per_file, args.offset, tuple(args.split)))
    saver_proc.start()

    n_workers = min(args.nworkers, len(trajs))
    chunks = [trajs[i::n_workers] for i in range(n_workers)]
    confs = [(c, record_queue, args.T, args.target_width, args.seperate,
              args.infer_gripper, args.separate_views) for c in chunks]
    workers = [Process(target=save_worker, args=(conf,)) for conf in confs]
    for w in workers:
        w.start()
    for w in workers:
        w.join()

    record_queue.put(None)
    saver_proc.join()


if __name__ == '__main__':
    main()
