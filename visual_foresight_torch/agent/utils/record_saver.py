"""Buffered GZIP-TFRecord trajectory writer with a self-describing manifest.

The port's own copy of ``visual_foresight_tpu/agent/utils/record_saver.py``
(``save_tf_record`` and ``RecordSaver``): trajectories are drawn into
train/test/val buffers, flushed every ``traj_per_file``, features are keyed
``"{t}/{key}"`` per timestep, and the first trajectory's shapes and dtypes
make a manifest (txt + pkl) from which the reader rebuilds the tensors;
and ``HDF5SaverBase``, the HDF5 writer of ``agent/utils/hdf5_saver.py``.
"""

import os
import pickle as pkl
from collections import OrderedDict

import numpy as np

from visual_foresight_torch.data.tfrecord_io import (  # noqa: F401  (re-export)
    TFRecordWriter, bytes_feature, encode_example, float_feature, int64_feature)


def save_tf_record(filename, trajectory_list, sequence_manifest, metadata_manifest):
    """Write a list of (meta_data, per-timestep feature dict list) trajectories
    into one GZIP TFRecord file, validating every record against the manifest."""

    def check_against_manifest(features, manifest):
        if manifest is None and features is not None:
            raise ValueError('Manifest is None but values were given')
        if features is None and manifest is not None:
            raise ValueError('Features are None but manifest is given')
        for k in features:
            assert k in manifest, 'key {} written but not in manifest'.format(k)
        for k in manifest:
            assert k in features, 'key {} in manifest but missing from record'.format(k)

    filename = filename + '.tfrecords'
    print(filename)
    with TFRecordWriter(filename, compression='GZIP') as writer:
        for meta_data, sequence_data in trajectory_list:
            check_against_manifest(meta_data, metadata_manifest)
            feature = {}
            for tind, feats in enumerate(sequence_data):
                check_against_manifest(feats, sequence_manifest)
                for k in feats:
                    feature['{}/{}'.format(tind, k)] = feats[k]
            feature.update(meta_data)
            writer.write(encode_example(feature))


class RecordSaver:
    def __init__(self, data_save_dir, sequence_length=None, traj_per_file=1,
                 offset=0, split=(0.90, 0.05, 0.05)):
        self._traj_buffers = [[] for _ in range(3)]
        self._save_counters = [0, 0, 0]

        for d in ('train', 'test', 'val'):
            path = os.path.join(data_save_dir, d)
            if not os.path.exists(path):
                print('Creating dir:', path)
                os.makedirs(path)

        self._base_dir = data_save_dir
        self._train_test_val = split
        self._traj_per_file = traj_per_file
        self._metadata_keys, self._sequence_keys = None, None
        self._T = sequence_length
        self._offset = offset
        # when a split weight is exactly 1 no coin-flip seeding of empty modes
        self._force_draw = any(i == 1 for i in split)

    def add_traj(self, traj):
        draw = None
        if not self._force_draw:
            # seed each non-empty mode with at least one early trajectory;
            # count buffered-but-unflushed trajs too — save counters only
            # move on file flush (every traj_per_file), so gating on them
            # alone would keep force-feeding val/test until each flushed a
            # whole file, starving train of ~2*traj_per_file early trajs
            for i in range(3):
                if self._save_counters[i] == 0 and \
                        not self._traj_buffers[i] and \
                        self._train_test_val[i] > 0 and \
                        np.random.randint(0, 2) == 1:
                    draw = i
        if draw is None:
            draw = np.random.choice([0, 1, 2], 1, p=self._train_test_val)[0]
        self._traj_buffers[draw].append(traj)
        self._save()

    def flush(self):
        self._save(True)

    def add_metadata_entry(self, key, shape, dtype):
        assert dtype in ('Float', 'Int', 'Byte'), 'invalid type {}'.format(dtype)
        if self._metadata_keys is None:
            self._metadata_keys = OrderedDict()
        self._metadata_keys[key] = (shape, dtype)

    @property
    def sequence_length(self):
        return self._T

    @sequence_length.setter
    def sequence_length(self, T):
        self._T = T

    def add_sequence_entry(self, key, shape, dtype):
        if self._T is None:
            raise ValueError('sequence_length not set during construction!')
        assert dtype in ('Float', 'Int', 'Byte', 'Jpeg'), \
            'invalid type {}'.format(dtype)
        if self._sequence_keys is None:
            self._sequence_keys = OrderedDict()
        self._sequence_keys[key] = (shape, dtype)

    def save_manifest(self):
        if self._metadata_keys is None and self._sequence_keys is None:
            raise ValueError('keys never added to manifest')

        with open(os.path.join(self._base_dir, 'manifest.txt'), 'w') as f:
            f.write('# DATA MANIFEST\n')
            f.write('#' * 62 + '\n\n')
            if self._metadata_keys is not None:
                f.write('# Trajectory meta-data\n')
                for key, (shape, dtype) in self._metadata_keys.items():
                    shape_str = ', '.join(str(s) for s in shape)
                    f.write('{}: ({}) - {}\n'.format(key, shape_str, dtype))
                f.write('\n' + '#' * 62 + '\n\n')
            if self._sequence_keys is not None:
                f.write('# Sequence Data\n')
                f.write('Timesteps: {}\n'.format(self._T))
                for key, (shape, dtype) in self._sequence_keys.items():
                    shape_str = ', '.join(str(s) for s in shape)
                    f.write('{}: ({}) - {}\n'.format(key, shape_str, dtype))

        with open(os.path.join(self._base_dir, 'manifest.pkl'), 'wb') as f:
            pkl.dump({'sequence_data': self._sequence_keys,
                      'traj_metadata': self._metadata_keys,
                      'T': self._T}, f)

    def __len__(self):
        return sum(self._save_counters)

    def _save(self, flush=False):
        for i, name in enumerate(('train', 'test', 'val')):
            buffer = self._traj_buffers[i]
            if len(buffer) == 0:
                continue
            if flush or len(buffer) % self._traj_per_file == 0:
                next_counter = self._save_counters[i] + len(buffer)
                num_saved = sum(self._save_counters) + self._offset
                next_total = num_saved + len(buffer)
                file = os.path.join(self._base_dir, name,
                                    'traj_{}_to_{}'.format(num_saved, next_total - 1))
                save_tf_record(file, buffer, self._sequence_keys, self._metadata_keys)
                self._traj_buffers[i] = []
                self._save_counters[i] = next_counter


class HDF5SaverBase:
    """Train/val/test-bucketed HDF5 trajectory writer
    (reference ``record_saver.py:184-235``).  ``h5py`` is imported where a
    file is written."""

    def __init__(self, save_dir, traj_per_file, offset=0,
                 split=(0.90, 0.05, 0.05), split_train_val_test=True):
        self.train_test_val_split = split
        self.split_train_val_test = split_train_val_test
        self.traj_per_file = traj_per_file
        self.traj_lists = [[], [], []]
        self.save_dir = save_dir
        self.traj_count = offset

    def save_hdf5(self, traj_list, prefix):
        import h5py
        if self.split_train_val_test:
            savedir = os.path.join(self.save_dir, 'hdf5', prefix)
        else:
            savedir = os.path.join(self.save_dir, 'hdf5')
        os.makedirs(savedir, exist_ok=True)
        self.traj_count += 1

        fname = 'traj_{}to{}.h5'.format((self.traj_count - 1) * self.traj_per_file,
                                        self.traj_count * self.traj_per_file)
        with h5py.File(os.path.join(savedir, fname), 'w') as F:
            F['traj_per_file'] = self.traj_per_file
            for i, traj in enumerate(traj_list):
                key = 'traj{}'.format(i)
                assert traj['images'].dtype == np.uint8, 'images must be uint8'
                for name, value in traj.items():
                    F[key + '/' + name] = value

    def make_traj(self, *args, **kwargs):
        raise NotImplementedError

    def save_traj(self, *args, **kwargs):
        raise NotImplementedError

    def _save_traj(self, traj):
        draw = np.random.choice([0, 1, 2], 1, p=self.train_test_val_split)[0]
        self.traj_lists[draw].append(traj)
        for i, prefix in enumerate(('train', 'val', 'test')):
            if len(self.traj_lists[i]) == self.traj_per_file:
                self.save_hdf5(self.traj_lists[i], prefix)
                self.traj_lists[i] = []
