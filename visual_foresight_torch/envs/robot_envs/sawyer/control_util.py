"""Sawyer control helpers (reference ``robot_envs/sawyer/control_util.py``).

Quintic-spline cartesian interpolation sampled at the 800 Hz control rate and
turned into a per-tick joint-angle lookup table through IK, plus the endpoint
state listener.

The port's copy of
``visual_foresight_tpu/envs/robot_envs/sawyer/control_util.py``.
"""

import threading

import numpy as np

from visual_foresight_torch.envs.util.interpolation import QuinticSpline

CONTROL_RATE = 800
CONTROL_PERIOD = 1.0 / CONTROL_RATE
INTERP_SKIP = 16
NEUTRAL_JOINT_ANGLES = np.array([0.412271, -0.434908, -1.198768, 1.795462,
                                 1.160788, 1.107675, -1.11748145])
NEUTRAL_JOINT_CMD = {k: a for k, a in zip(
    ['right_j{}'.format(i) for i in range(7)], NEUTRAL_JOINT_ANGLES)}
N_JOINTS = 7
max_vel_mag = np.array([0.88, 0.678, 0.996, 0.996, 1.776, 1.776, 2.316])
max_accel_mag = np.array([3.5, 2.5, 5, 5, 5, 5, 5])
RESET_SKIP = 800


def _slerp(q1, q2, frac):
    from scipy.spatial.transform import Rotation, Slerp
    rots = Rotation.from_quat([np.roll(q1, -1), np.roll(q2, -1)])  # wxyz->xyzw
    out = Slerp([0.0, 1.0], rots)(np.clip(frac, 0, 1))
    return np.roll(out.as_quat(), 1)                               # ->wxyz


def precalculate_interpolation(p1, q1, p2, q2, duration, last_pos, start_cmd,
                               joint_names, ik_fn):
    """Sample the quintic cartesian path every INTERP_SKIP control ticks and
    run IK at each sample, seeding each solve with the previous solution.

    :param ik_fn: callable (xyz, quat_wxyz, seed_joint_cmd) -> joint dict
    :return: (num_samples, N_JOINTS) joint-angle lookup table
    """
    spline = QuinticSpline(np.asarray(p1), np.asarray(p2), duration)
    num_queries = int(CONTROL_RATE * duration / INTERP_SKIP) + 1
    jas = []
    last_cmd = start_cmd
    for t in np.linspace(0.0, duration, num_queries):
        cart_pos = spline.get(t)[0][0]
        interp_quat = _slerp(np.asarray(q1), np.asarray(q2), t / duration)
        try:
            last_cmd = ik_fn(cart_pos[:3], interp_quat, last_cmd)
            last_pos = np.array([last_cmd[j] for j in joint_names])
        except Exception:
            # IK failure: hold the previous solution for this sample
            pass
        jas.append(last_pos.copy())

    # expand lookup table to per-tick resolution via linear interpolation
    jas = np.asarray(jas)
    ticks = int(CONTROL_RATE * duration) + 1
    fine = np.empty((ticks, jas.shape[1]))
    xs = np.linspace(0, 1, len(jas))
    fine_xs = np.linspace(0, 1, ticks)
    for j in range(jas.shape[1]):
        fine[:, j] = np.interp(fine_xs, xs, jas[:, j])
    return fine


class LatestEEObs:
    """Mutex-guarded latest endpoint state from the intera topic."""

    def __init__(self):
        import rospy
        from intera_core_msgs.msg import EndpointState
        self._mutex = threading.Lock()
        self._eep = None
        self._first = threading.Semaphore(value=0)
        rospy.Subscriber('/robot/limb/right/endpoint_state', EndpointState,
                         self._cb)
        self._first.acquire()

    def _cb(self, state):
        pose = state.pose
        with self._mutex:
            first = self._eep is None
            self._eep = np.array([
                pose.position.x, pose.position.y, pose.position.z,
                pose.orientation.w, pose.orientation.x, pose.orientation.y,
                pose.orientation.z])
            if first:
                self._first.release()

    def get_eep(self):
        with self._mutex:
            return self._eep.copy()
