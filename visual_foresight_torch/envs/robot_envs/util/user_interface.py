"""Matplotlib click UI for designating start/goal pixels
(reference ``robot_envs/util/user_interface.py``).

The port's copy of ``visual_foresight_tpu/envs/robot_envs/util/
user_interface.py``, with one divergence: matplotlib is imported inside
``select_points``, not when the module is imported.  ``base_env`` imports
this module, and a machine without matplotlib (where the clicks come from a
script) still builds the robot envs; ``select_points`` itself names the
missing package.
"""

import os

import numpy as np


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError('select_points needs matplotlib to show the camera '
                          'images and collect the clicks: {}'.format(e))
    if not os.environ.get('DISPLAY'):
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def select_points(images, cam_names, prefix, save_dir=None,
                  clicks_per_desig=2, n_desig=1):
    """Show each camera image and collect clicks.

    :param images: (ncam, H, W, 3) uint8
    :param clicks_per_desig: 2 -> returns (desig, goal) pixel arrays each
        (ncam, n_desig, 2); 1 -> returns a single (ncam, n_desig, 2) array
    """
    plt = _pyplot()
    n_cam = images.shape[0]
    desig = np.zeros((n_cam, n_desig, 2), dtype=np.int64)
    goal = np.zeros((n_cam, n_desig, 2), dtype=np.int64)

    for i in range(n_cam):
        name = cam_names[i] if i < len(cam_names) else 'cam{}'.format(i)
        fig = plt.figure()
        ax = fig.add_subplot(111)
        ax.set_title('{}: click {} point(s){}'.format(
            name, n_desig * clicks_per_desig,
            ' (desig, then goal)' if clicks_per_desig == 2 else ''))
        ax.imshow(images[i])
        clicks = plt.ginput(n=n_desig * clicks_per_desig, timeout=0)
        plt.close(fig)
        for p in range(n_desig):
            if clicks_per_desig == 2:
                (c1, r1), (c2, r2) = clicks[2 * p], clicks[2 * p + 1]
                desig[i, p] = [int(r1), int(c1)]
                goal[i, p] = [int(r2), int(c2)]
            else:
                c1, r1 = clicks[p]
                desig[i, p] = [int(r1), int(c1)]
        if save_dir:
            annotated = images[i].copy()
            for p in range(n_desig):
                annotated[desig[i, p, 0], desig[i, p, 1]] = [255, 0, 0]
                if clicks_per_desig == 2:
                    annotated[goal[i, p, 0], goal[i, p, 1]] = [0, 0, 255]
            plt.imsave(os.path.join(save_dir, '{}_{}.png'.format(prefix, name)),
                       annotated)

    if clicks_per_desig == 2:
        return desig, goal
    return desig
