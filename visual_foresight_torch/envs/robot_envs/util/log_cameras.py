"""Snapshot (and optionally calibrate) the robot cameras.

Capability of reference ``foresight_rospkg/src/log_cameras.py``: grab one
frame per camera topic, write timestamped JPEGs, and — with ``--calibrate``
— run the click-based point selector used to build camera calibrations.
Works against either image source the framework supports: ROS topics or the
native shared-memory camera ring (``native/camera_stream``).

CLI::

    python -m visual_foresight_torch.envs.robot_envs.util.log_cameras \
        <save_dir> [--calibrate] [--topic_names front left ...]

The port's copy of
``visual_foresight_tpu/envs/robot_envs/util/log_cameras.py``.
"""

import argparse
import datetime
import os

import numpy as np


def grab_views(topic_names, height=480, width=640):
    """One RGB frame per camera name.  With ROS present, names address
    ``/<name>/image_raw`` topics; otherwise each name is a native
    shared-memory camera channel (``native/camera_stream --channel <name>``).
    """
    from .camera_recorder import CameraRecorder
    from .topic_utils import IMTopic

    try:
        import rospy  # noqa: F401
        fmt = '/{}/image_raw'.format
    except ImportError:
        fmt = '{}'.format

    frames = []
    for name in topic_names:
        recorder = CameraRecorder(IMTopic(fmt(name), height=height,
                                          width=width))
        _, img = recorder.get_image()
        frames.append(img.copy())
    return frames


def main(cmd_args=None):
    parser = argparse.ArgumentParser(description='logs current camera views')
    parser.add_argument('save_dir', type=str,
                        help='where to save views/calibration')
    parser.add_argument('--calibrate', action='store_true', default=False,
                        help='also collect calibration click points')
    parser.add_argument('--topic_names', type=str, nargs='+',
                        default=['front', 'left', 'right_side', 'left_side',
                                 'right'])
    parser.add_argument('--height', type=int, default=480)
    parser.add_argument('--width', type=int, default=640)
    args = parser.parse_args(cmd_args)

    frames = grab_views(args.topic_names, args.height, args.width)

    now = datetime.datetime.today()
    out = os.path.join(args.save_dir, 'clicks_{}_{}_{}_{}_{}'.format(
        now.year, now.month, now.day, now.hour, now.minute))
    os.makedirs(out, exist_ok=True)

    if args.calibrate:
        from .user_interface import select_points
        select_points(np.stack(frames), args.topic_names, '', out,
                      clicks_per_desig=1, n_desig=4)
    else:
        import cv2
        for img, cam in zip(frames, args.topic_names):
            cv2.imwrite(os.path.join(out, '{}.jpg'.format(cam)),
                        img[:, :, ::-1])
    print('saved {} views to {}'.format(len(frames), out))
    return out


if __name__ == '__main__':
    main()
