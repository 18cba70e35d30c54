"""MoveIt-free KUKA iiwa planning interface.

The reference ``visual_mpc/envs/robot_envs/kuka/kuka_interface.py`` (475 LoC)
drives the arm through ``moveit_commander``: plan to a Cartesian position
under a keep-upright orientation constraint, reject plans longer than
``MAX_PATH_LENGTH`` points by re-planning with a randomized yaw, clamp
targets to the bin workspace, sweep objects back to the bin centre through a
fixed waypoint circuit, and expose joint/Cartesian state.  All of that logic
lives *here*; only the actuation is behind a pluggable ``commander`` so the
planner is hermetically testable and works over either the iiwa_stack topics
or a fake.

Capability map vs the reference:

* ``_plan_to_position``  -> reference lines 161-200 (set_pose_target + plan +
  replan-with-random-yaw loop, neutral-reset after 20 failed replans)
* ``_calc_plan_statistics`` -> lines 110-158 (per-joint travel / max step /
  max vel-accel, error logs past the 0.1 rad step and 1.5 rad travel budgets)
* ``move_kuka_to_eep`` workspace clamp -> lines 233-249
* ``redistribute_kuka_objects`` -> lines 303-363 (the P1..P23 sweep)
* state getters -> lines 372-414

The port's copy of
``visual_foresight_tpu/envs/robot_envs/kuka/kuka_interface.py``.
"""

import logging
from typing import List, NamedTuple, Optional

import numpy as np

from .inverse_kinematics import CHAIN, NEUTRAL, IKError

MAX_PATH_LENGTH = 15          # reference line 90
MAX_JOINT_STEP = 0.1          # rad per plan point (reference's statistics budget)
TRAVEL_BUDGET = 1.5           # total joint travel before the planner warns
NEUTRAL_POSITION = np.array([0.6, -0.05, 0.4])   # reference line 203
# bin workspace clamp, reference lines 236-249
WORKSPACE_LOW = np.array([0.52, -0.28, 0.15])
WORKSPACE_HIGH = np.array([0.68, 0.18, 0.25])
# downward-pointing EE: R = Rx(pi), yaw free (the orientation-constraint
# tolerance of +-0.7 rad about x/y, free about z — reference lines 62-79)
_DOWN_QUAT = np.array([0.0, 1.0, 0.0, 0.0])      # wxyz

log = logging.getLogger('robot_logger')


class Plan(NamedTuple):
    """A joint-space trajectory: (P, 7) waypoints at a fixed dt."""
    points: np.ndarray
    dt: float


class FakeCommander:
    """In-memory commander for hermetic tests: executes plans instantly."""

    def __init__(self, q0=None):
        self.q = np.asarray(q0 if q0 is not None else NEUTRAL, np.float64)
        self.executed: List[Plan] = []

    def get_joint_angles(self):
        return self.q.copy()

    def get_joint_velocities(self):
        return np.zeros_like(self.q)

    def get_joint_efforts(self):
        return np.zeros_like(self.q)

    def execute(self, plan: Plan):
        self.executed.append(plan)
        self.q = plan.points[-1].copy()


class IiwaRosCommander:
    """iiwa_stack-backed commander (splined JointPosition streaming)."""

    def __init__(self, control_rate=100):
        from .kuka_impedance import KukaImpedanceController
        self._ctrl = KukaImpedanceController(control_rate=control_rate)

    def get_joint_angles(self):
        return self._ctrl.get_joint_angles()

    def get_joint_velocities(self):
        return np.zeros(CHAIN.n)

    def get_joint_efforts(self):
        return np.zeros(CHAIN.n)

    def execute(self, plan: Plan):
        self._ctrl.move_to_ja(list(plan.points),
                              duration=max(plan.dt * len(plan.points), 0.5))


def _quat_with_yaw(yaw: float) -> np.ndarray:
    """Downward EE orientation with a free yaw: Rz(yaw) @ Rx(pi), wxyz."""
    half = yaw / 2.0
    # quaternion product (cos h, 0, 0, sin h) * (0, 1, 0, 0)
    return np.array([0.0, np.cos(half), np.sin(half), 0.0])


class KukaInterface:
    def __init__(self, commander=None, seed: Optional[int] = None):
        self._commander = commander if commander is not None \
            else IiwaRosCommander()
        self._rng = np.random.RandomState(seed)
        self.traj_num = -1
        self.im_num = 0

    # -- planning -------------------------------------------------------------------

    def _calc_plan_statistics(self, plan: Plan, print_stats=False):
        """Total joint travel with per-joint max-step / vel / accel budgets
        (reference lines 110-158; the wrist joint is excluded there too)."""
        pts = plan.points
        if len(pts) == 0:
            log.error('Plan is empty. No statistics will be calculated')
            return None
        body = slice(0, pts.shape[1] - 1)       # ignore wrist joint
        diffs = np.abs(np.diff(pts[:, body], axis=0))
        total = diffs.sum(axis=0)
        max_step = diffs.max(axis=0) if len(diffs) else np.zeros(pts.shape[1] - 1)
        vels = diffs / plan.dt
        accels = np.abs(np.diff(vels, axis=0)) / plan.dt if len(vels) > 1 \
            else np.zeros_like(vels)
        if print_stats:
            log.info('plan stats: travel=%s max_step=%s max_vel=%s '
                     'max_accel=%s', total, max_step,
                     vels.max(axis=0) if len(vels) else 0,
                     accels.max(axis=0) if len(accels) else 0)
        if max_step.size and max_step.max() > MAX_JOINT_STEP:
            log.error('Max distance: %f', max_step.max())
        if total.sum() > TRAVEL_BUDGET:
            log.error('total move: %f', total.sum())
        return float(total.sum())

    def _joint_plan(self, q_target: np.ndarray, dt=0.1) -> Plan:
        """Linear joint interpolation from the current configuration, one
        point per MAX_JOINT_STEP of the largest joint move."""
        q0 = self._commander.get_joint_angles()
        span = float(np.max(np.abs(q_target - q0)))
        n_pts = max(int(np.ceil(span / MAX_JOINT_STEP)) + 1, 2)
        alphas = np.linspace(0.0, 1.0, n_pts)[:, None]
        return Plan(points=q0[None] + alphas * (q_target - q0)[None], dt=dt)

    def _plan_to_position(self, position) -> Plan:
        """Plan to a Cartesian position with a downward EE, re-planning with
        a randomized yaw while the path exceeds MAX_PATH_LENGTH points
        (reference lines 161-200)."""
        position = np.asarray(position, np.float64)
        yaw = 0.0
        replan_count = 0
        while True:
            try:
                q_target = CHAIN.ik(position, _quat_with_yaw(yaw),
                                    seed=self._commander.get_joint_angles(),
                                    nullspace_goal=NEUTRAL)
                plan = self._joint_plan(q_target)
            except IKError:
                plan = Plan(points=np.zeros((0, CHAIN.n)), dt=0.1)
            if len(plan.points) and len(plan.points) <= MAX_PATH_LENGTH:
                self._calc_plan_statistics(plan, print_stats=True)
                return plan
            replan_count += 1
            yaw = 2.0 * np.pi * self._rng.random_sample()
            if replan_count > 20:
                log.error('Planning failed.  Attempting to reset position')
                self.move_kuka_to_neutral()
                replan_count = 0

    # -- motion ---------------------------------------------------------------------

    def move_kuka_to_neutral(self):
        plan = self._joint_plan(np.asarray(NEUTRAL))
        self._commander.execute(plan)
        self.traj_num += 1

    def move_kuka_to_eep(self, target_pose):
        """Clamp to the bin workspace, plan, execute (reference lines 233-279)."""
        p = np.clip(np.asarray(target_pose[:3], np.float64),
                    WORKSPACE_LOW, WORKSPACE_HIGH)
        plan = self._plan_to_position(p)
        if not len(plan.points):
            log.error('No trajectory found')
        else:
            self._commander.execute(plan)
        return p

    def move_kuka_to_ja(self, waypoints, duration=1.5):
        """Joint-space move through waypoints (the reference stubs this out —
        line 294 — but the commander abstraction makes it free here)."""
        dt = duration / max(len(waypoints), 1)
        for wp in waypoints:
            self._commander.execute(
                Plan(points=np.stack([self._commander.get_joint_angles(),
                                      np.asarray(wp, np.float64)]), dt=dt))

    def redistribute_kuka_objects(self):
        """Sweep objects back toward the bin centre through the reference's
        fixed waypoint circuit (lines 303-363)."""
        waypoints = [
            (0.5, -0.05, 0.4), (0.5, -0.05, 0.2), (0.6, -0.05, 0.2),
            (0.5, -0.3, 0.4), (0.5, -0.3, 0.2), (0.6, -0.15, 0.2),
            (0.6, -0.3, 0.4), (0.6, -0.3, 0.2), (0.6, -0.15, 0.2),
            (0.7, -0.3, 0.4), (0.7, -0.3, 0.2), (0.6, -0.15, 0.2),
            (0.7, -0.05, 0.4), (0.7, -0.05, 0.2), (0.6, -0.05, 0.2),
            (0.7, 0.2, 0.4), (0.7, 0.2, 0.2), (0.6, 0.1, 0.2),
            (0.6, 0.2, 0.4), (0.6, 0.2, 0.2), (0.6, 0.1, 0.2),
            (0.5, 0.2, 0.4), (0.5, 0.2, 0.2), (0.6, 0.1, 0.2),
            (0.5, -0.05, 0.4),
        ]
        for wp in waypoints:
            plan = self._plan_to_position(np.asarray(wp))
            if len(plan.points):
                self._commander.execute(plan)
            else:
                log.error('No trajectory found')

    # -- state ----------------------------------------------------------------------

    def get_kuka_state(self):
        return (self.get_kuka_joint_angles(),
                self.get_kuka_joint_angles_velocity(),
                self.get_kuka_cartesian_pose())

    def get_kuka_joint_angles(self):
        return self._commander.get_joint_angles()

    def get_kuka_joint_angles_velocity(self):
        return self._commander.get_joint_velocities()

    def get_kuka_joint_angles_effort(self):
        return self._commander.get_joint_efforts()

    def get_kuka_joint_angles_names(self):
        return list(CHAIN.joint_names)

    def get_kuka_cartesian_pose(self):
        return CHAIN.fk_pose(self._commander.get_joint_angles())

    def get_xyz_quat(self):
        eep = self.get_kuka_cartesian_pose()
        x, y, z = eep[:3]
        w, qx, qy, qz = eep[3:]
        return x, y, z, qx, qy, qz, w
