"""Serialization of agent trajectories into TFRecord features.

The port's own copy of ``visual_foresight_tpu/agent/utils/traj_saver.py``:
``GeneralAgentSaver`` maps (agent_data, obs, policy_out) dicts to typed
features keyed ``env/<k>``, ``env/image_view{c}/encoded`` and
``policy/<k>``; ``record_worker`` is the saver process's loop.  JPEG coding
needs OpenCV, imported where a frame is encoded.
"""

import os

import numpy as np

from .record_saver import RecordSaver, bytes_feature, float_feature, int64_feature


def get_dtype(datum):
    if isinstance(datum, bool):
        return 'Int'
    if isinstance(datum, int):
        return 'Int'
    if isinstance(datum, float):
        return 'Float'
    if isinstance(datum, np.ndarray):
        if datum.dtype == np.uint8:
            return 'Byte'
        if datum.dtype.kind == 'i':
            return 'Int'
        if datum.dtype.kind == 'f':
            return 'Float'
        if datum.dtype.kind == 'b':
            return 'Int'
    raise ValueError('datum {!r} has unsupported dtype'.format(datum))


def convert_datum(datum):
    if isinstance(datum, np.ndarray):
        if datum.dtype == np.uint8:
            return bytes_feature(datum.tobytes())
        if datum.dtype.kind == 'i':
            return int64_feature(datum.flatten().tolist())
        if datum.dtype.kind == 'f':
            return float_feature(datum.flatten().tolist())
        if datum.dtype.kind == 'b':
            return int64_feature(datum.astype(np.int64).flatten().tolist())
    elif isinstance(datum, bool):
        return int64_feature([int(datum)])
    elif isinstance(datum, float):
        return float_feature([datum])
    elif isinstance(datum, int):
        return int64_feature([datum])
    raise ValueError('datum {!r} has unsupported dtype'.format(datum))


def _get_shape(datum):
    if isinstance(datum, np.ndarray):
        return datum.shape
    return (1,)


def jpeg_encode(rgb_frame, quality=92):
    """uint8 HWC RGB frame -> JPEG bytes (libjpeg-turbo via OpenCV)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError('JPEG coding needs OpenCV (cv2), which does not '
                          'import here') from e
    ok, buf = cv2.imencode('.jpg', rgb_frame[..., ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    if not ok:
        raise ValueError('JPEG encode failed for frame {}'.format(
            rgb_frame.shape))
    return buf.tobytes()


class GeneralAgentSaver:
    """Serializes trajectories and hands them to RecordSaver(s); optionally
    routes goal-reached trajs into a separate 'good' dataset."""

    def __init__(self, save_dir, sequence_length, seperate_good=False,
                 traj_per_file=128, offset=0, split=(0.90, 0.05, 0.05),
                 image_coding='raw'):
        assert image_coding in ('raw', 'jpeg'), image_coding
        self._base_dir = save_dir
        self._seperate_good = seperate_good
        self._image_coding = image_coding
        self._manifest_saved, self._T = False, sequence_length

        if seperate_good:
            self._good_saver = RecordSaver(os.path.join(save_dir, 'good'),
                                           sequence_length, traj_per_file, offset, split)
            self._bad_saver = RecordSaver(os.path.join(save_dir, 'bad'),
                                          sequence_length, traj_per_file, offset, split)
        else:
            self._saver = RecordSaver(save_dir, sequence_length, traj_per_file,
                                      offset, split)

    @staticmethod
    def _serializable(value):
        try:
            get_dtype(value)
            return True
        except ValueError:
            return False

    def _save_manifests(self, agent_data, obs, policy_out):
        savers = [self._good_saver, self._bad_saver] if self._seperate_good else [self._saver]
        # non-tensor payloads (e.g. CEM plan_stat dicts, verbose handles) are
        # dropped from records — raw pkl saving keeps them
        self._skip_meta = {k for k in (agent_data or {})
                           if not self._serializable(agent_data[k])}
        self._skip_policy = {k for k in (policy_out[0] if policy_out else {})
                             if not self._serializable(policy_out[0][k])}
        if self._skip_meta or self._skip_policy:
            print('record saver: skipping non-tensor keys {}'.format(
                sorted(self._skip_meta | self._skip_policy)))
        agent_data = {k: v for k, v in (agent_data or {}).items()
                      if k not in self._skip_meta}
        policy_out = [{k: v for k, v in p.items() if k not in self._skip_policy}
                      for p in (policy_out or [])]
        for s in savers:
            if agent_data is not None:
                for k in agent_data:
                    s.add_metadata_entry(k, _get_shape(agent_data[k]), get_dtype(agent_data[k]))
            if obs is not None:
                for k in obs:
                    if k == 'images':
                        img_dtype = ('Jpeg' if self._image_coding == 'jpeg'
                                     else get_dtype(obs[k][0, 0]))
                        for c in range(obs[k].shape[1]):
                            s.add_sequence_entry('env/image_view{}/encoded'.format(c),
                                                 _get_shape(obs[k][0, 0]),
                                                 img_dtype)
                    else:
                        s.add_sequence_entry('env/{}'.format(k), _get_shape(obs[k][0]),
                                             get_dtype(obs[k][0]))
            if policy_out:
                for k in policy_out[0]:
                    s.add_sequence_entry('policy/{}'.format(k),
                                         _get_shape(policy_out[0][k]),
                                         get_dtype(policy_out[0][k]))
            s.save_manifest()

    def save_traj(self, agent_data, obs, policy_out):
        is_good = None
        if self._seperate_good:
            is_good = agent_data.pop('goal_reached')
        if 'traj_ok' in agent_data and not agent_data.pop('traj_ok'):
            print('RECEIVED NOT OKAY TRAJ, MAYBE UP ITERS?')
            return

        if not self._manifest_saved:
            self._save_manifests(agent_data, obs, policy_out)
            self._manifest_saved = True

        meta_data_dict = {k: convert_datum(v) for k, v in agent_data.items()
                          if k not in self._skip_meta}
        sequence_data = []
        for t in range(self._T):
            step_dict = {}
            for k in obs:
                if k == 'images':
                    for c in range(obs[k].shape[1]):
                        frame = obs[k][t, c]
                        if self._image_coding == 'jpeg':
                            feat = bytes_feature(jpeg_encode(frame))
                        else:
                            feat = convert_datum(frame)
                        step_dict['env/image_view{}/encoded'.format(c)] = feat
                else:
                    step_dict['env/{}'.format(k)] = convert_datum(obs[k][t])
            if len(policy_out) > t:
                for k in policy_out[t]:
                    if k in self._skip_policy:
                        continue
                    step_dict['policy/{}'.format(k)] = convert_datum(policy_out[t][k])
            sequence_data.append(step_dict)

        traj = (meta_data_dict, sequence_data)
        if self._seperate_good and is_good:
            self._good_saver.add_traj(traj)
        elif self._seperate_good:
            self._bad_saver.add_traj(traj)
        else:
            self._saver.add_traj(traj)

    def flush(self):
        if self._seperate_good:
            self._good_saver.flush()
            self._bad_saver.flush()
            total = len(self._bad_saver) + len(self._good_saver)
            if total > 0:
                print('Perc good: {}'.format(len(self._good_saver) / float(total) * 100.0))
        else:
            self._saver.flush()


def record_worker(queue, save_dir, sequence_length, seperate_good, traj_per_file,
                  offset=0, split=(0.90, 0.05, 0.05), image_coding='raw'):
    """Saver-process main loop: drain (agent_data, obs, policy_out) tuples until
    a ``None`` sentinel arrives, then flush."""
    print('started saver with PID:', os.getpid())
    print('saving to {}'.format(save_dir))
    saver = GeneralAgentSaver(save_dir, sequence_length, seperate_good,
                              traj_per_file, offset, split, image_coding)
    counter = 0
    data = queue.get(True)
    while data is not None:
        counter += 1
        agent_data, obs, policy_out = data
        saver.save_traj(agent_data, obs, policy_out)
        data = queue.get(True)
    print('Saved {} trajs as tfrecords'.format(counter))
    saver.flush()
