"""Spawn one native camera_stream per video device
(capability of reference ``foresight_rospkg/launch/start_cameras.py``).

CLI::

    python -m visual_foresight_torch.native.start_cameras [--devices /dev/video0,...]
        [--fps 30 --width 640 --height 480] [--test-pattern N]

The port's copy of ``visual_foresight_tpu/native/start_cameras.py``: the
node is built from ``camera_stream.cpp`` beside this file by
``ops/_build.py::build_host_executable`` into ``build/native/`` (never by
``make`` in a package directory).
"""

import argparse
import glob
import signal
import subprocess
import sys

SOURCE = 'camera_stream.cpp'
LIBS = ('-lrt',)


def ensure_built():
    """The camera node's path, built at first use."""
    from visual_foresight_torch.ops import _build
    return str(_build.build_host_executable(SOURCE, LIBS))


def main(cmd_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--devices', type=str, default='',
                        help='comma-separated v4l2 devices (default: all)')
    parser.add_argument('--fps', type=float, default=30)
    parser.add_argument('--width', type=int, default=640)
    parser.add_argument('--height', type=int, default=480)
    parser.add_argument('--flip-h', action='store_true')
    parser.add_argument('--flip-v', action='store_true')
    parser.add_argument('--test-pattern', type=int, default=0,
                        help='spawn N synthetic cameras instead of devices')
    args = parser.parse_args(cmd_args)

    binary = ensure_built()
    procs = []

    def spawn(channel, extra):
        cmd = [binary, '--channel', channel, '--fps', str(args.fps),
               '--width', str(args.width), '--height', str(args.height)]
        if args.flip_h:
            cmd.append('--flip-h')
        if args.flip_v:
            cmd.append('--flip-v')
        cmd += extra
        print('starting', ' '.join(cmd))
        procs.append(subprocess.Popen(cmd))

    if args.test_pattern:
        for i in range(args.test_pattern):
            spawn('cam{}'.format(i), ['--test-pattern'])
    else:
        devices = args.devices.split(',') if args.devices else \
            sorted(glob.glob('/dev/video*'))[::2]  # even nodes = capture
        if not devices:
            print('no video devices found; use --test-pattern N')
            return 1
        for i, dev in enumerate(devices):
            spawn('cam{}'.format(i), ['--device', dev])

    def shutdown(*_):
        for p in procs:
            p.terminate()
        sys.exit(0)

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    for p in procs:
        p.wait()
    return 0


if __name__ == '__main__':
    sys.exit(main())
