"""Dataset QA CLI (reference ``visual_mpc/utils/check_dataset.py``).

The port's counterpart of ``visual_foresight_tpu/utils/check_dataset.py``
on the port's ``BaseVideoDataset``: tiles sample frames, counts lift
successes, and prints action-delta statistics for a TFRecord dataset.
``cv2`` is imported when the tiles are written.

CLI::

    python -m visual_foresight_torch.utils.check_dataset <records_dir> \
        [--batch_size N] [--out tiles.png]
"""

import argparse

import numpy as np

from visual_foresight_torch.data.dataset_reader import BaseVideoDataset


def tile_frames(images, max_rows=8):
    """(B, T, ncam, H, W, 3) uint8 -> one tiled uint8 image (rows=trajs,
    cols=time, cam 0)."""
    b, t = images.shape[:2]
    rows = []
    for i in range(min(b, max_rows)):
        rows.append(np.concatenate(list(images[i, :, 0]), axis=1))
    return np.concatenate(rows, axis=0)


def lift_success_rate(states, z_dim=1, z_thresh=0.02):
    """Fraction of trajectories whose arm-z exceeds z_thresh at some step with
    the gripper (last state dim) closed: the xz-grasp lift heuristic."""
    closed = states[..., -1] <= 0.9
    high = states[..., z_dim] >= z_thresh
    return float(np.mean(np.any(np.logical_and(closed, high), axis=1)))


def action_stats(actions):
    deltas = np.abs(np.diff(actions, axis=1))
    return {
        'action_mean': actions.mean(axis=(0, 1)).tolist(),
        'action_std': actions.std(axis=(0, 1)).tolist(),
        'action_absmax': np.abs(actions).max(axis=(0, 1)).tolist(),
        'delta_mean': deltas.mean(axis=(0, 1)).tolist(),
    }


def main(cmd_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('records_dir', type=str)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--mode', type=str, default='train')
    parser.add_argument('--out', type=str, default='dataset_check.png')
    args = parser.parse_args(cmd_args)

    ds = BaseVideoDataset(args.records_dir, args.batch_size,
                          hparams_dict={'shuffle': False})
    images = ds.get('images', args.mode)
    states = ds.get('state', args.mode)
    actions = ds.get('actions', args.mode)
    ds.close()

    print('images', images.shape, images.dtype)
    print('states', states.shape, 'actions', actions.shape)
    print('lift success rate (batch):', lift_success_rate(states))
    for k, v in action_stats(actions).items():
        print(k, np.round(v, 4))

    import cv2
    tiled = tile_frames(images)
    cv2.imwrite(args.out, tiled[:, :, ::-1])
    print('wrote', args.out)


if __name__ == '__main__':
    main()
