"""Copy the first records of a TFRecord split into a small corpus of its
own, on the port: the twin of ``scripts/extract_sample_trajs.py``.

It copies the first ``--n`` records of the split's first shard record by
record (no decode) through the port's ``data/tfrecord_io.py``, and the
records root's ``manifest.pkl`` and ``manifest.txt``: a self-contained
corpus that ``BaseVideoDataset`` reads, as ``tests/assets/ag_r4s_sample``
was made.  Host only.

Usage::

    python -m visual_foresight_torch.tools.extract_sample_trajs \\
        <records>/good tests/assets/ag_r4s_sample/good --n 2
"""

import argparse
import glob
import os
import shutil

from visual_foresight_torch.data.tfrecord_io import (TFRecordWriter,
                                                     tfrecord_iterator)


def extract(src_root, out_root, n, split='train'):
    shards = sorted(glob.glob(os.path.join(src_root, split, '*.tfrecords')))
    if not shards:
        raise SystemExit('no shards under {}/{}'.format(src_root, split))
    os.makedirs(os.path.join(out_root, split), exist_ok=True)
    for name in ('manifest.pkl', 'manifest.txt'):
        src = os.path.join(src_root, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out_root, name))
    out_path = os.path.join(out_root, split,
                            'traj_0_to_{}.tfrecords'.format(n - 1))
    count = 0
    with TFRecordWriter(out_path) as writer:
        for payload in tfrecord_iterator(shards[0]):
            writer.write(payload)
            count += 1
            if count >= n:
                break
    print('wrote {} records -> {}'.format(count, out_path))
    return count


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('src_root', help='records split root (has manifest.pkl)')
    p.add_argument('out_root')
    p.add_argument('--n', type=int, default=2)
    p.add_argument('--split', default='train')
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return extract(args.src_root, args.out_root, args.n, args.split)


if __name__ == '__main__':
    main()
