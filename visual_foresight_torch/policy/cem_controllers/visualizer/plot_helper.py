"""Score histogram plotting (reference ``visualizer/plot_helper.py``).

matplotlib is imported where a histogram is drawn: the plan dumps and the
rest of the port run without it.
"""

import numpy as np


def plot_score_hist(scores, tick_value=None, tick_label='expert'):
    """Histogram of CEM sample scores, optional expert comparison tick;
    returns the figure image as a uint8 array."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig = plt.figure()
    plt.hist(np.asarray(scores).ravel(), bins=30)
    if tick_value is not None:
        plt.axvline(tick_value, color='r', linestyle='--', label=tick_label)
        plt.legend()
    plt.xlabel('score')
    plt.ylabel('count')
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
    plt.close(fig)
    return buf
