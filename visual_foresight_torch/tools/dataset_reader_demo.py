"""Dataset reading demo on the port: the twin of
``examples/dataset_reader_demo.py``.

Reads a collected TFRecord dataset through the port's reader
(``data/dataset_reader.py``), prints the batch shapes and the actions'
statistics, and writes one tiled frame grid, ``dataset_demo.png`` in the
working directory, for a look by eye.  Host only.

Usage::

    python -m visual_foresight_torch.tools.dataset_reader_demo \\
        <records_dir> [batch_size]
"""

import sys

import numpy as np

from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
from visual_foresight_torch.utils.check_dataset import tile_frames


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    directory = argv[0]
    batch_size = int(argv[1]) if len(argv) > 1 else 4

    ds = BaseVideoDataset(directory, batch_size)
    images = ds['images', 'train']
    states = ds['state', 'train']
    actions = ds['actions', 'train']

    print('images:', images.shape, images.dtype)
    print('states:', states.shape)
    print('actions:', actions.shape)
    print('action stats: mean {} std {}'.format(
        np.round(actions.mean((0, 1)), 4), np.round(actions.std((0, 1)), 4)))

    import cv2
    tiled = tile_frames(images)
    cv2.imwrite('dataset_demo.png', tiled[:, :, ::-1])
    print('wrote dataset_demo.png')
    return 0


if __name__ == '__main__':
    sys.exit(main())
