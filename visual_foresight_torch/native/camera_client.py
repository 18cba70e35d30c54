"""Python client for the native camera node's shared-memory ring.

Reads frames published by ``camera_stream`` (see ``shm_ring.h`` for the
layout) with a lock-free seqlock retry loop.  Used by CameraRecorder when ROS
is unavailable.

The port's copy of ``visual_foresight_tpu/native/camera_client.py``.  The
shared-memory name (``/dev/shm/vftpu_cam_<channel>``), the header and slot
layouts and the magic number are those of the JAX package's node, kept so
that a node of either package feeds a client of either package.
"""

import mmap
import os
import struct
import time

import numpy as np

_MAGIC = 0x56465450
# magic, version, width, height, channels, n_slots (6 u32) + pad + frame_bytes,
# write_counter (2 u64)
_HEADER_FMT = '<6I Q Q'
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
_SLOT_HEADER_FMT = '<Q d'
_SLOT_HEADER_SIZE = struct.calcsize(_SLOT_HEADER_FMT)


class ShmCameraClient:
    def __init__(self, channel, wait_timeout=30.0):
        # accept either a bare channel name or a ROS-style topic path
        name = channel.strip('/').replace('/', '_')
        if not name.startswith('vftpu_cam_'):
            name = 'vftpu_cam_' + name
        self._path = '/dev/shm/' + name

        deadline = time.time() + wait_timeout
        while not os.path.exists(self._path):
            if time.time() > deadline:
                raise FileNotFoundError(
                    'camera shm {} not found — is camera_stream running?'
                    .format(self._path))
            time.sleep(0.1)

        f = open(self._path, 'rb')
        self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        f.close()

        deadline = time.time() + wait_timeout
        while True:
            (magic, version, self.width, self.height, self.channels,
             self.n_slots, self.frame_bytes, _) = struct.unpack_from(
                _HEADER_FMT, self._mm, 0)
            if magic == _MAGIC:
                break
            if time.time() > deadline:
                raise RuntimeError('camera shm never initialized')
            time.sleep(0.05)
        self._slot_stride = _SLOT_HEADER_SIZE + self.frame_bytes
        self._last_counter = 0

    def _read_counter(self):
        return struct.unpack_from('<Q', self._mm,
                                  _HEADER_SIZE - 8)[0]

    def read_frame(self, timeout=1.0, block_new=True):
        """Return the newest (H, W, 3) uint8 frame, or None on timeout.

        With ``block_new`` the call waits for a frame newer than the last one
        returned (poll-free consumers get every-frame cadence)."""
        deadline = time.time() + timeout
        while True:
            counter = self._read_counter()
            if counter > (self._last_counter if block_new else 0):
                break
            if time.time() > deadline:
                return None
            time.sleep(0.002)

        for _ in range(16):  # seqlock retry
            counter = self._read_counter()
            if counter == 0:
                return None
            idx = (counter - 1) % self.n_slots
            base = _HEADER_SIZE + idx * self._slot_stride
            seq0, tstamp = struct.unpack_from(_SLOT_HEADER_FMT, self._mm, base)
            if seq0 % 2 == 1:
                continue
            frame = np.frombuffer(
                self._mm, dtype=np.uint8, count=self.frame_bytes,
                offset=base + _SLOT_HEADER_SIZE).copy()
            seq1 = struct.unpack_from('<Q', self._mm, base)[0]
            if seq0 == seq1:
                self._last_counter = counter
                self.last_timestamp = tstamp
                return frame.reshape(self.height, self.width, self.channels)
        return None

    def close(self):
        self._mm.close()
