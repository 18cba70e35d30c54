"""Raw trajectory -> RoboNet-format HDF5 export
(reference ``visual_mpc/utils/file_2_hdf5.py``).

Frames are stored jpeg- or mp4-encoded inside the h5 file; mandatory
experiment-metadata keys match the RoboNet schema so exported files interop
with RoboNet tooling.  ``cv2``, ``h5py`` and ``imageio`` are imported where
they are used.

CLI::

    python -m visual_foresight_torch.utils.file_2_hdf5 <out_dir> <paths> \
        --metadata meta.json [--encoding jpeg|mp4]

The port's own copy of ``visual_foresight_tpu/utils/file_2_hdf5.py``.
"""

import argparse
import glob
import json
import os
import pickle as pkl
import random

import tempfile

import numpy as np

MANDATORY_KEYS = ['camera_configuration', 'policy_desc', 'bin_type',
                  'bin_insert', 'contains_annotation', 'robot', 'gripper',
                  'background', 'action_space', 'object_classes',
                  'primitives', 'camera_type']


def serialize_image(img):
    """RGB uint8 frame -> JPEG bytes, byte-compatible with the reference /
    RoboNet-release convention (``visual_mpc/utils/file_2_hdf5.py:21``):
    the RGB array goes into ``cv2.imencode`` with NO channel swap, so the
    stored JPEG carries the channels in cv2's BGR slots.  Decoding with
    ``cv2.imdecode`` and no swap hands the original RGB array straight back
    (``data/robonet_reader._decode_jpeg``); external JPEG viewers see R/B
    swapped colors — a quirk the RoboNet release shares."""
    import cv2
    assert img.dtype == np.uint8, 'must be uint8'
    return cv2.imencode('.jpg', img)[1]


def serialize_video(imgs, temp_name_append):
    """Encode (T, H, W, 3) uint8 frames as an in-memory mp4 byte buffer,
    through a temporary file in the temporary directory (the JAX package
    writes it into the working directory)."""
    import imageio
    assert imgs.dtype == np.uint8, 'must be uint8'
    fd, mp4_name = tempfile.mkstemp(suffix='_{}.mp4'.format(temp_name_append))
    os.close(fd)
    try:
        writer = imageio.get_writer(mp4_name, fps=10)
        for frame in imgs:
            writer.append_data(frame)
        writer.close()
        with open(mp4_name, 'rb') as f:
            buf = f.read()
    finally:
        if os.path.exists(mp4_name):
            os.remove(mp4_name)
    return np.frombuffer(buf, dtype=np.uint8)


def save_dict(data_container, dict_group, video_encoding, t_index):
    """Write one obs/policy/agent dict into an h5 group, encoding frames."""
    for k, d in data_container.items():
        if k == 'images':
            T, n_cams = d.shape[:2]
            dict_group.attrs['n_cams'] = n_cams
            dict_group.attrs['cam_encoding'] = video_encoding
            for n in range(n_cams):
                cam_group = dict_group.create_group('cam{}_video'.format(n))
                if video_encoding == 'mp4':
                    data = cam_group.create_dataset(
                        'frames', data=serialize_video(d[:, n], t_index))
                    data.attrs['shape'] = d[0, n].shape
                    data.attrs['T'] = d.shape[0]
                    data.attrs['image_format'] = 'RGB'
                elif video_encoding == 'jpeg':
                    for t in range(T):
                        data = cam_group.create_dataset(
                            'frame{}'.format(t), data=serialize_image(d[t, n]))
                        data.attrs['shape'] = d[t, n].shape
                        data.attrs['image_format'] = 'RGB'
                else:
                    raise ValueError('unknown encoding {}'.format(
                        video_encoding))
        elif isinstance(d, np.ndarray):
            dict_group.create_dataset(k, data=d)
        elif isinstance(d, (int, float, bool, str)):
            dict_group.attrs[k] = d
        elif isinstance(d, list) and d and isinstance(d[0], dict):
            # e.g. policy_out: list of per-step dicts -> stacked datasets
            keys = d[0].keys()
            for kk in keys:
                try:
                    dict_group.create_dataset(
                        kk, data=np.stack([p[kk] for p in d]))
                except (ValueError, TypeError):
                    pass


def save_hdf5(path, agent_data, obs_dict, policy_out, metadata,
              video_encoding='jpeg', t_index=0):
    import h5py
    for key in MANDATORY_KEYS:
        assert key in metadata, 'missing mandatory metadata key {}'.format(key)
    with h5py.File(path, 'w') as F:
        F.attrs['file_version'] = 'vftpu-1.0'
        meta_group = F.create_group('metadata')
        for k, v in metadata.items():
            meta_group.attrs[k] = json.dumps(v) if isinstance(
                v, (list, dict)) else v
        save_dict(obs_dict, F.create_group('env'), video_encoding, t_index)
        save_dict({'policy_out': policy_out} if isinstance(policy_out, list)
                  else policy_out, F.create_group('policy'), video_encoding,
                  t_index)
        save_dict(agent_data, F.create_group('misc'), video_encoding, t_index)


def load_traj(traj_folder, T=None):
    import cv2
    with open('{}/agent_data.pkl'.format(traj_folder), 'rb') as f:
        agent_data = pkl.load(f)
    with open('{}/obs_dict.pkl'.format(traj_folder), 'rb') as f:
        obs_dict = pkl.load(f)
    with open('{}/policy_out.pkl'.format(traj_folder), 'rb') as f:
        policy_out = pkl.load(f)
    if 'images' not in obs_dict:
        ncam = len(glob.glob('{}/images*/'.format(traj_folder)))
        frames = []
        t = 0
        while True:
            cams = []
            for n in range(ncam):
                hit = None
                for ext in ('jpg', 'png'):
                    p = '{}/images{}/im_{}.{}'.format(traj_folder, n, t, ext)
                    if os.path.isfile(p):
                        hit = cv2.imread(p)[:, :, ::-1]
                        break
                if hit is None:
                    cams = None
                    break
                cams.append(hit)
            if cams is None or (T is not None and t >= T):
                break
            frames.append(np.stack(cams))
            t += 1
        if frames:
            obs_dict['images'] = np.stack(frames)
    return agent_data, obs_dict, policy_out


def main(cmd_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('out_dir', type=str)
    parser.add_argument('paths', type=str)
    parser.add_argument('--metadata', type=str, required=True,
                        help='json file with RoboNet metadata keys')
    parser.add_argument('--encoding', type=str, default='jpeg',
                        choices=['jpeg', 'mp4'])
    parser.add_argument('--T', type=int, default=None)
    args = parser.parse_args(cmd_args)

    with open(args.metadata) as f:
        metadata = json.load(f)

    trajs = []
    for path in args.paths.split(':'):
        trajs.extend(glob.glob('{}/traj_group*/traj*'.format(path)))
        trajs.extend(glob.glob('{}/raw/traj_group*/traj*'.format(path)))
    trajs = sorted(set(t for t in trajs if os.path.isdir(t)))
    random.shuffle(trajs)
    os.makedirs(args.out_dir, exist_ok=True)
    for i, traj in enumerate(trajs):
        agent_data, obs_dict, policy_out = load_traj(traj, args.T)
        out = os.path.join(args.out_dir, 'traj{}.hdf5'.format(i))
        save_hdf5(out, agent_data, obs_dict, policy_out, metadata,
                  args.encoding, i)
        print('wrote', out)


if __name__ == '__main__':
    main()
