"""Vendor-service-free serial-arm kinematics (FK / geometric Jacobian /
damped-least-squares IK).

The port's copy of ``visual_foresight_tpu/envs/robot_envs/util/
kinematics.py`` (numpy and scipy; the same solutions).

The reference resolves Cartesian targets to joint angles through per-robot
ROS IK *services* (`SolvePositionIK` wrappers in
``visual_mpc/envs/robot_envs/sawyer/inverse_kinematics.py`` and the
baxter/kuka twins, ~183 LoC each) or through pybullet
(``widowx/widowx_controller.py``).  Both make the control stack depend on
vendor daemons that are unavailable off-robot and untestable hermetically.
This module replaces the *solver* with a self-contained numpy implementation;
the per-robot ``inverse_kinematics.py`` modules define the chain geometry and
keep the reference's call surface.

Design notes
------------
* Joints are URDF-style: a fixed parent transform (``origin_xyz`` +
  ``origin_rpy``) followed by a revolute rotation about ``axis`` in the
  rotated frame.  A classic Denavit-Hartenberg table maps onto this via
  :func:`chain_from_dh`.
* IK is damped least squares (Levenberg-Marquardt on the twist error) with
  joint-limit clamping and an optional nullspace bias toward a comfort pose
  — the same knob the reference exposes as ``use_nullspace_goal``
  (``sawyer/inverse_kinematics.py:59-67``).
* Everything is plain float64 numpy: solves are microseconds-long,
  host-side, and inside ROS callbacks: no reason to involve the card.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


class IKError(RuntimeError):
    """The solver did not reach the requested pose tolerance."""


class Joint(NamedTuple):
    name: str
    origin_xyz: Tuple[float, float, float]
    origin_rpy: Tuple[float, float, float]
    axis: Tuple[float, float, float]
    lower: float
    upper: float
    # home-position angle offset: the transform rotates by (q + offset) while
    # limits apply to q — how a DH theta offset maps onto a URDF joint
    offset: float = 0.0


def rpy_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """URDF fixed-axis rpy: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation about a unit axis."""
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    return np.array([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c]])


def quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion, wxyz (the repo-wide convention)."""
    from scipy.spatial.transform import Rotation
    return np.roll(Rotation.from_matrix(R).as_quat(), 1)


def matrix_from_quat(quat_wxyz: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation
    return Rotation.from_quat(np.roll(np.asarray(quat_wxyz, np.float64),
                                      -1)).as_matrix()


def orientation_error(R_target: np.ndarray, R_current: np.ndarray) -> np.ndarray:
    """Axis-angle rotation vector taking R_current onto R_target (world frame)."""
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(R_target @ R_current.T).as_rotvec()


class SerialChain:
    """A revolute serial chain with an optional fixed end-effector offset."""

    def __init__(self, joints: Sequence[Joint],
                 ee_offset_xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                 ee_offset_rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                 base_xyz: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                 base_rpy: Tuple[float, float, float] = (0.0, 0.0, 0.0)):
        self.joints = list(joints)
        self.n = len(self.joints)
        self._ee_T = np.eye(4)
        self._ee_T[:3, :3] = rpy_matrix(*ee_offset_rpy)
        self._ee_T[:3, 3] = ee_offset_xyz
        self._base_T = np.eye(4)
        self._base_T[:3, :3] = rpy_matrix(*base_rpy)
        self._base_T[:3, 3] = base_xyz
        self.lower = np.array([j.lower for j in self.joints])
        self.upper = np.array([j.upper for j in self.joints])
        self._axes = [np.asarray(j.axis, np.float64) /
                      np.linalg.norm(j.axis) for j in self.joints]
        self._offsets = np.array([j.offset for j in self.joints])
        self._fixed = []
        for j in self.joints:
            T = np.eye(4)
            T[:3, :3] = rpy_matrix(*j.origin_rpy)
            T[:3, 3] = j.origin_xyz
            self._fixed.append(T)

    @property
    def joint_names(self):
        return [j.name for j in self.joints]

    def clip(self, q: np.ndarray) -> np.ndarray:
        return np.clip(q, self.lower, self.upper)

    def _frames(self, q: np.ndarray):
        """World transforms after each joint, plus the EE transform."""
        T = self._base_T.copy()
        frames = []
        for i in range(self.n):
            T = T @ self._fixed[i]
            Tr = np.eye(4)
            Tr[:3, :3] = axis_angle_matrix(
                self._axes[i], float(q[i]) + self._offsets[i])
            T = T @ Tr
            frames.append(T)
        return frames, T @ self._ee_T

    def fk(self, q: np.ndarray) -> np.ndarray:
        """(n,) joint angles -> (4,4) world end-effector transform."""
        return self._frames(np.asarray(q, np.float64))[1]

    def fk_pose(self, q: np.ndarray) -> np.ndarray:
        """(n,) joint angles -> (7,) [xyz, quat wxyz]."""
        T = self.fk(q)
        return np.concatenate([T[:3, 3], quat_from_matrix(T[:3, :3])])

    def jacobian(self, q: np.ndarray) -> np.ndarray:
        """Geometric Jacobian (6, n): rows = [linear; angular] world twist."""
        frames, ee = self._frames(np.asarray(q, np.float64))
        p_ee = ee[:3, 3]
        J = np.zeros((6, self.n))
        for i, T in enumerate(frames):
            z = T[:3, :3] @ self._axes[i]
            J[:3, i] = np.cross(z, p_ee - T[:3, 3])
            J[3:, i] = z
        return J

    def ik(self, xyz: np.ndarray,
           quat_wxyz: Optional[np.ndarray] = None,
           seed: Optional[np.ndarray] = None,
           nullspace_goal: Optional[np.ndarray] = None,
           nullspace_gain: float = 0.4,
           pos_tol: float = 1e-4, rot_tol: float = 1e-3,
           max_iters: int = 200, damping: float = 1e-3) -> np.ndarray:
        """Damped-least-squares IK.

        :param quat_wxyz: target orientation; ``None`` solves position-only
            (the free orientation falls out of the nullspace/seed)
        :param seed: starting joint vector (mid-range when omitted)
        :param nullspace_goal: joint vector to bias toward in the task
            nullspace — the reference's ``use_nullspace_goal`` semantics
        :raises IKError: tolerance not reached within ``max_iters``
        """
        xyz = np.asarray(xyz, np.float64)
        R_t = matrix_from_quat(quat_wxyz) if quat_wxyz is not None else None
        q = (np.asarray(seed, np.float64).copy() if seed is not None
             else 0.5 * (self.lower + self.upper))
        q = self.clip(q)
        rows = 6 if R_t is not None else 3
        for _ in range(max_iters):
            frames, ee = self._frames(q)
            e_pos = xyz - ee[:3, 3]
            if R_t is not None:
                e_rot = orientation_error(R_t, ee[:3, :3])
                if (np.linalg.norm(e_pos) < pos_tol and
                        np.linalg.norm(e_rot) < rot_tol):
                    return q
                err = np.concatenate([e_pos, e_rot])
            else:
                if np.linalg.norm(e_pos) < pos_tol:
                    return q
                err = e_pos
            J = self.jacobian(q)[:rows]
            JJt = J @ J.T + (damping ** 2) * np.eye(rows)
            dq = J.T @ np.linalg.solve(JJt, err)
            if nullspace_goal is not None:
                # project the comfort-pose pull into the task nullspace
                J_pinv = J.T @ np.linalg.inv(JJt)
                N = np.eye(self.n) - J_pinv @ J
                dq = dq + nullspace_gain * (N @ (np.asarray(nullspace_goal)
                                                 - q))
            step = np.linalg.norm(dq)
            if step > 0.5:   # trust region: keep the linearization honest
                dq *= 0.5 / step
            q = self.clip(q + dq)
        raise IKError('IK did not converge to {} within {} iters'
                      .format(xyz, max_iters))


def chain_from_dh(names: Sequence[str], a: Sequence[float],
                  d: Sequence[float], alpha: Sequence[float],
                  lower: Sequence[float], upper: Sequence[float],
                  theta_offset: Optional[Sequence[float]] = None,
                  **kwargs) -> SerialChain:
    """Build a chain from a classic (distal) Denavit-Hartenberg table.

    Standard DH link i: Rz(theta_i) Tz(d_i) Tx(a_i) Rx(alpha_i).  In
    URDF-joint form the fixed part of joint i is the *previous* row's
    Tz(d)Tx(a)Rx(alpha) — each row's translation folds into the next joint's
    origin, the rotation axis is always local z, and a theta offset becomes
    an additive home-angle offset (Rx(a)Rz(off)Rz(q) == Rx(a)Rz(q+off)).
    """
    n = len(d)
    off = list(theta_offset) if theta_offset is not None else [0.0] * n
    joints = []
    prev_a, prev_alpha, prev_d = 0.0, 0.0, 0.0
    for i in range(n):
        joints.append(Joint(
            name=names[i],
            origin_xyz=(prev_a, 0.0, prev_d),
            origin_rpy=(prev_alpha, 0.0, 0.0),
            axis=(0.0, 0.0, 1.0),
            lower=lower[i], upper=upper[i], offset=off[i]))
        prev_a, prev_alpha, prev_d = a[i], alpha[i], d[i]
    # the last row's fixed part becomes the EE offset (folded the same way)
    return SerialChain(joints, ee_offset_xyz=(prev_a, 0.0, prev_d),
                       ee_offset_rpy=(prev_alpha, 0.0, 0.0), **kwargs)


# -- reference-shaped pose records (ROS-message-free) ---------------------------------

class _Vec3:
    __slots__ = ('x', 'y', 'z')

    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)


class _Quat:
    __slots__ = ('x', 'y', 'z', 'w')

    def __init__(self, x=0.0, y=0.0, z=0.0, w=1.0):
        self.x, self.y, self.z, self.w = (float(x), float(y), float(z),
                                          float(w))


class Pose:
    """Duck-typed ``geometry_msgs/Pose`` so reference-shaped call sites work
    without ROS on the box."""

    def __init__(self, position=None, orientation=None):
        self.position = position or _Vec3()
        self.orientation = orientation or _Quat()


class PoseStamped:
    def __init__(self, pose=None):
        self.pose = pose or Pose()


def make_pose_stamped(x, y, z, quat_wxyz) -> PoseStamped:
    """Reference ``get_pose_stamped`` shape (sawyer/inverse_kinematics.py:118)."""
    w, qx, qy, qz = [float(v) for v in quat_wxyz]
    return PoseStamped(Pose(_Vec3(x, y, z), _Quat(qx, qy, qz, w)))


def make_point_stamped(x, y, z) -> PoseStamped:
    """Reference ``get_point_stamped`` shape — position-only target (the
    all-zero quaternion is ROS's 'orientation unset' convention, which
    ``pose_to_arrays`` maps to a position-only solve)."""
    return PoseStamped(Pose(_Vec3(x, y, z), _Quat(0.0, 0.0, 0.0, 0.0)))


class ReferenceIKService:
    """The reference per-robot ``inverse_kinematics.py`` call surface
    (``get_joint_angles(pose, seed_cmd, use_advanced_options)`` returning a
    joint-command dict — sawyer/inverse_kinematics.py:24-104) backed by the
    DLS solver instead of a vendor ROS service."""

    def __init__(self, chain: SerialChain, neutral: np.ndarray):
        self.chain = chain
        self.neutral = np.asarray(neutral, np.float64)

    def cmd_from_array(self, q) -> dict:
        return {n: float(v) for n, v in zip(self.chain.joint_names, q)}

    def array_from_cmd(self, cmd) -> np.ndarray:
        """Reference ``joint_state_from_cmd`` equivalent: dict -> ordered array."""
        return np.array([cmd[n] for n in self.chain.joint_names])

    def get_joint_angles(self, pose, seed_cmd=None,
                         use_advanced_options=False) -> dict:
        """:param pose: PoseStamped-shaped record (ours or a real ROS msg)
        :param seed_cmd: joint-command dict to seed the solve
        :param use_advanced_options: bias toward the neutral pose in the task
            nullspace (the reference's SEED_USER + nullspace-goal path)
        :raises IKError: target unreachable within tolerance
        """
        xyz, quat = pose_to_arrays(pose)
        seed = self.array_from_cmd(seed_cmd) if seed_cmd else self.neutral
        q = self.chain.ik(
            xyz, quat, seed=seed,
            nullspace_goal=self.neutral if use_advanced_options else None)
        return self.cmd_from_array(q)

    def fk_cmd(self, cmd) -> np.ndarray:
        return self.chain.fk_pose(self.array_from_cmd(cmd))


def pose_to_arrays(pose_stamped) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(xyz, quat_wxyz-or-None) from a PoseStamped-shaped record (ours or ROS)."""
    p = pose_stamped.pose.position
    o = getattr(pose_stamped.pose, 'orientation', None)
    xyz = np.array([p.x, p.y, p.z])
    if o is None:
        return xyz, None
    quat = np.array([o.w, o.x, o.y, o.z])
    if np.linalg.norm(quat) < 1e-8:   # unset orientation == position-only
        return xyz, None
    return xyz, quat / np.linalg.norm(quat)
