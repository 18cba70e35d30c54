"""Async file-writing worker.

A background process drains a manager queue of
``('path'|'txt_file'|'mov'|'img', ...)`` tuples so gif/html/img writes never
block the rollout loop (reference ``visual_mpc/agent/utils/file_saver.py:9-53``).

The worker is forked, and in the port its parent has usually initialised
CUDA already.  So the worker never touches torch: everything put on the
queue must be numpy or plain Python (``check_host_item`` refuses a tensor
before it is pickled).  Movies are GIF89a from the port's own encoder
(``utils/gif.py``), whatever the file's extension; PNGs need OpenCV,
imported in the worker when it writes one.
"""

import logging
import os
from multiprocessing import Manager, Process

import numpy as np

from visual_foresight_torch.utils.gif import write_gif


class _FileQueue:
    """The manager queue, refusing anything that is not host data."""

    def __init__(self, queue, proc, manager):
        self._queue = queue
        self._proc = proc
        self._manager = manager

    def put(self, item):
        check_host_item(item)
        self._queue.put(item)

    def close(self):
        """Wait until the worker has written everything queued, then stop it
        and the manager."""
        self._queue.put(None)
        self._proc.join()
        self._manager.shutdown()


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
    file_queue = manager.Queue()
    proc = Process(target=_file_worker, args=(file_queue,), daemon=True)
    proc.start()
    return _FileQueue(file_queue, proc, manager)


def _make_parent_if_needed(file_name):
    parent = os.path.dirname(file_name)
    if parent and not os.path.exists(parent):
        os.makedirs(parent, exist_ok=True)


def _file_worker(file_queue):
    logging.debug('file saver started, PID %d', os.getpid())
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
            write_gif(path, [np.asarray(f, dtype=np.uint8) for f in data[2]],
                      fps)
        elif kind == 'img':
            import cv2
            path = os.path.join(prepend_path, data[1])
            _make_parent_if_needed(path)
            cv2.imwrite(path, np.asarray(data[2])[:, :, ::-1])
        try:
            data = file_queue.get(True)
        except (EOFError, OSError):
            return
