"""Dataset gif summaries (reference ``visual_mpc/utils/summarize_dataset.py``).

CLI::

    python -m visual_foresight_torch.utils.summarize_dataset <records_dir> \
        [--n N] [--out_dir summaries]

The port's own copy of ``visual_foresight_tpu/utils/summarize_dataset.py``.
"""

import argparse
import os

import numpy as np

from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
from visual_foresight_torch.utils.im_utils import npy_to_gif


def main(cmd_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('records_dir', type=str)
    parser.add_argument('--n', type=int, default=4)
    parser.add_argument('--mode', type=str, default='train')
    parser.add_argument('--out_dir', type=str, default='summaries')
    args = parser.parse_args(cmd_args)

    ds = BaseVideoDataset(args.records_dir, args.n,
                          hparams_dict={'shuffle': False})
    images = ds.get('images', args.mode)   # (B,T,ncam,H,W,3)
    os.makedirs(args.out_dir, exist_ok=True)
    for i in range(images.shape[0]):
        for c in range(images.shape[2]):
            frames = [images[i, t, c] for t in range(images.shape[1])]
            npy_to_gif(frames, os.path.join(
                args.out_dir, 'traj{}_cam{}'.format(i, c)))
    print('wrote {} gifs to {}'.format(
        images.shape[0] * images.shape[2], args.out_dir))


if __name__ == '__main__':
    main()
