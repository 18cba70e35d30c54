"""Image helpers on the agent's hot path.

``resize_store`` is the only image resize on the rollout hot loop
(reference ``visual_mpc/utils/im_utils.py:6-15``): it area-resizes each camera
frame into the time-indexed uint8 cache.  ``npy_to_gif`` writes through the
port's own GIF89a encoder (``utils/gif.py``), so it needs no ``imageio``.
OpenCV is imported only where a frame must be resized.
"""

import numpy as np

from .gif import write_gif


def resize_store(t, target_array, input_array):
    """Resize ncam frames into ``target_array[t]`` (INTER_AREA, matching the
    reference's downsample quality choice)."""
    target_h, target_w = target_array.shape[2:4]
    if (target_h, target_w) == input_array.shape[1:3]:
        target_array[t] = input_array
        return
    import cv2
    for cam in range(input_array.shape[0]):
        target_array[t, cam] = cv2.resize(
            input_array[cam], (target_w, target_h), interpolation=cv2.INTER_AREA)


def npy_to_gif(im_list, filename, fps=4):
    if not filename.endswith('.gif'):
        filename = filename + '.gif'
    write_gif(filename, [np.asarray(f, dtype=np.uint8) for f in im_list], fps)
