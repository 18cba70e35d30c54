"""Async file-writing worker.

A background process drains a manager queue of
``('path'|'txt_file'|'mov'|'img', ...)`` tuples so gif/html/img writes never
block the rollout loop (reference ``visual_mpc/agent/utils/file_saver.py:9-53``).

The worker is forked, and in the port its parent has usually initialised
CUDA already.  So the worker never touches torch: everything put on the
queue must be numpy or plain Python (``check_host_item`` refuses a tensor
before it is pickled).  A movie whose name ends in ``.mp4`` is written as
an MPEG-4 file through OpenCV's ``VideoWriter`` (``mp4v``, at the item's
fps), and the worker raises ``Mp4Unwritable`` where that writer does not
open; every other
movie is GIF89a from the port's own encoder (``utils/gif.py``).  PNGs need
OpenCV too, imported in the worker when it writes one.  A worker that
raised makes ``close`` raise with its error: ``Mp4Unwritable`` where that
was the worker's, else ``RuntimeError``.
"""

import logging
import os
from multiprocessing import Manager, Process

import numpy as np

from visual_foresight_torch.utils.gif import write_gif


class Mp4Unwritable(RuntimeError):
    """OpenCV's ``VideoWriter`` did not open an mp4 file."""


class _FileQueue:
    """The manager queue, refusing anything that is not host data."""

    def __init__(self, queue, proc, manager, errors):
        self._queue = queue
        self._proc = proc
        self._manager = manager
        self._errors = errors

    def put(self, item):
        check_host_item(item)
        self._queue.put(item)

    def close(self):
        """Wait until the worker has written everything queued, then stop it
        and the manager.  Raises where the worker failed."""
        self._queue.put(None)
        self._proc.join()
        errors = list(self._errors)
        self._manager.shutdown()
        if errors or self._proc.exitcode:
            cls = Mp4Unwritable if any(
                kind == Mp4Unwritable.__name__ for kind, _ in errors) \
                else RuntimeError
            raise cls('the file worker failed (exit code {}): {}'.format(
                self._proc.exitcode,
                ' '.join('{}: {}'.format(*e) for e in errors)))


def check_host_item(item):
    """Raise where ``item`` holds anything but numpy and plain Python: a
    CUDA tensor pickled into the queue would make the worker touch CUDA."""
    if type(item).__module__.split('.')[0] == 'torch':
        raise TypeError('the file worker takes numpy arrays, not {}'.format(
            type(item).__name__))
    if isinstance(item, (list, tuple)):
        for x in item:
            check_host_item(x)


def start_file_worker():
    manager = Manager()
    file_queue, errors = manager.Queue(), manager.list()
    proc = Process(target=_file_worker, args=(file_queue, errors),
                   daemon=True)
    proc.start()
    return _FileQueue(file_queue, proc, manager, errors)


def _make_parent_if_needed(file_name):
    parent = os.path.dirname(file_name)
    if parent and not os.path.exists(parent):
        os.makedirs(parent, exist_ok=True)


def _write_mp4(path, frames, fps):
    """RGB ``frames`` as an MPEG-4 file (``mp4v``) through OpenCV; raises
    where the writer does not open."""
    import cv2
    if not frames:
        raise ValueError('no frames for {}'.format(path))
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'),
                             float(fps), (w, h))
    if not writer.isOpened():
        raise Mp4Unwritable('cv2.VideoWriter cannot open {} (mp4v, {}x{}, '
                           'OpenCV {})'.format(path, w, h, cv2.__version__))
    try:
        for frame in frames:
            writer.write(np.ascontiguousarray(frame[:, :, ::-1]))
    finally:
        writer.release()


def _file_worker(file_queue, errors):
    logging.debug('file saver started, PID %d', os.getpid())
    try:
        _drain(file_queue)
    except Exception as e:
        errors.append((type(e).__name__, str(e)))
        raise


def _drain(file_queue):
    prepend_path = './'
    try:
        data = file_queue.get(True)
    except (EOFError, OSError):
        return  # manager shut down before us (process exit)
    while data is not None:
        kind = data[0]
        if kind == 'path':
            prepend_path = data[1]
            os.makedirs(prepend_path, exist_ok=True)
        elif kind == 'txt_file':
            path = os.path.join(prepend_path, data[1])
            _make_parent_if_needed(path)
            with open(path, 'w') as f:
                f.write(data[2])
                f.write('\n')
        elif kind == 'mov':
            path = os.path.join(prepend_path, data[1])
            fps = data[3] if len(data) == 4 else 4
            frames = [np.asarray(f, dtype=np.uint8) for f in data[2]]
            if path.endswith('.mp4'):
                _make_parent_if_needed(path)
                _write_mp4(path, frames, fps)
            else:
                write_gif(path, frames, fps)
        elif kind == 'img':
            import cv2
            path = os.path.join(prepend_path, data[1])
            _make_parent_if_needed(path)
            cv2.imwrite(path, np.asarray(data[2])[:, :, ::-1])
        try:
            data = file_queue.get(True)
        except (EOFError, OSError):
            return
