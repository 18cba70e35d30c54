"""The port's native camera node (``visual_foresight_torch/native/
camera_stream.cpp``, built by ``ops/_build.py::build_host_executable`` into
``build/native/``) and its client, on the CPU.

- ``tests/test_native_camera.py``'s checks on the port's node and client:
  frames advance, the rate is near 60 fps, ``CameraRecorder`` reads the
  native ring (and ``close`` stops its reader), ``log_cameras`` writes one
  JPEG.
- ABI parity: the JAX package's ``camera_stream.cpp`` compiled with ``g++``
  into a temporary directory (never by ``make`` in its package).  The JAX
  client reads the port's ring and the port's client the JAX ring, with the
  same header fields, and each ring's last frame decodes byte for byte the
  same through either client and equals the test pattern of some frame
  counter (``camera_stream.cpp:100``).

Every channel carries the test process's pid; each ring is unlinked after.
"""

import glob
import os
import shutil
import subprocess
import time

import numpy as np
import pytest

import chip_smoke
from test_torch_planner import few_torch_threads  # noqa: F401
from visual_foresight_torch.native import camera_client as t_client
from visual_foresight_torch.native import start_cameras
from visual_foresight_tpu.native import camera_client as j_client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 64


def channel(name):
    return 'torch_{}_{}'.format(name, os.getpid())


@pytest.fixture(scope='module')
def stream():
    ch = channel('stream')
    with chip_smoke.CameraNodes([ch], H, W, fps=60):
        yield ch


def test_node_builds_into_build_native():
    exe = start_cameras.ensure_built()
    assert os.path.dirname(exe) == os.path.join(REPO, 'build', 'native')
    assert os.access(exe, os.X_OK)
    assert start_cameras.ensure_built() == exe       # built once


def test_frames_stream_and_change(stream):
    client = t_client.ShmCameraClient(stream, wait_timeout=10.0)
    assert (client.height, client.width, client.channels) == (H, W, 3)
    f1 = client.read_frame(timeout=2.0)
    assert f1 is not None and f1.shape == (H, W, 3)
    f2 = client.read_frame(timeout=2.0)
    assert f2 is not None and not np.array_equal(f1, f2)
    assert client.last_timestamp > 0
    client.close()


def test_frame_rate_throttled(stream):
    client = t_client.ShmCameraClient(stream, wait_timeout=10.0)
    client.read_frame(timeout=2.0)
    c0 = client._read_counter()
    time.sleep(1.0)
    rate = client._read_counter() - c0
    assert 25 <= rate <= 90, 'publish rate {} should be near 60 fps'.format(
        rate)
    client.close()


def test_camera_recorder_on_the_native_ring(stream):
    from visual_foresight_torch.envs.robot_envs.util.camera_recorder import (
        CameraRecorder)
    from visual_foresight_torch.envs.robot_envs.util.topic_utils import (
        IMTopic)
    rec = CameraRecorder(IMTopic(stream, height=24, width=32))
    stamp, img = rec.get_image()
    assert img.shape == (24, 32, 3) and abs(stamp - time.time()) < 5.0
    rec.close()
    assert not rec._poller.is_alive()


def test_log_cameras_snapshot(stream, tmp_path):
    import cv2
    from visual_foresight_torch.envs.robot_envs.util import log_cameras
    out = log_cameras.main([str(tmp_path), '--topic_names', stream,
                            '--height', str(H), '--width', str(W)])
    jpgs = glob.glob(os.path.join(out, '*.jpg'))
    assert [os.path.basename(p) for p in jpgs] == [stream + '.jpg']
    img = cv2.imread(jpgs[0])
    assert img.shape == (H, W, 3) and img.any()


def _pattern(t):
    """The node's test pattern at frame counter ``t``."""
    r, c = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    return np.stack([(r + t * 3) & 0xFF, (c + t * 5) & 0xFF,
                     (r + c + t) & 0xFF], axis=-1).astype(np.uint8)


def test_shm_abi_matches_the_jax_node(tmp_path):
    cxx = shutil.which('g++')
    if cxx is None:
        pytest.skip('no g++ to build the JAX package\'s node')
    jax_exe = str(tmp_path / 'camera_stream')
    src = os.path.join(REPO, 'visual_foresight_tpu', 'native',
                       'camera_stream.cpp')
    subprocess.run([cxx, '-O2', '-std=c++17', '-pthread', src, '-o',
                    jax_exe, '-lrt'], check=True, capture_output=True)
    nodes = {'port': start_cameras.ensure_built(), 'jax': jax_exe}
    rings = {}
    try:
        for side, exe in nodes.items():
            ch = channel('abi_' + side)
            rings[side] = ch
            subprocess.run([exe, '--channel', ch, '--test-pattern', '--width',
                            str(W), '--height', str(H), '--fps', '60',
                            '--max-frames', '6'], check=True, timeout=30,
                           stderr=subprocess.DEVNULL)
        for side, ch in rings.items():
            clients = [m.ShmCameraClient(ch, wait_timeout=5.0)
                       for m in (j_client, t_client)]
            headers = [(c.width, c.height, c.channels, c.n_slots,
                        c.frame_bytes, c._read_counter()) for c in clients]
            assert headers[0] == headers[1] == (W, H, 3, 8, W * H * 3, 6), \
                side
            frames = [c.read_frame(timeout=1.0, block_new=False)
                      for c in clients]
            np.testing.assert_array_equal(frames[0], frames[1])
            assert any(np.array_equal(frames[1], _pattern(t))
                       for t in range(64)), side
            clients[1].close()
    finally:
        for ch in rings.values():
            if os.path.exists(chip_smoke.CameraNodes.ring(ch)):
                os.remove(chip_smoke.CameraNodes.ring(ch))
