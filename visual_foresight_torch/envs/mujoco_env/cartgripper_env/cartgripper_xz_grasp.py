"""2-D (x, z) + binary-grasp lifting env, the smallest cartgripper variant
(capability parity: ``visual_mpc/envs/mujoco_env/cartgripper_env/cartgripper_xz_grasp.py``).

Agent space: adim=3 (dx, dz, grasp), sdim=3 ([x, z, gripper-openness]); 1 cam.
Scene constants (bounds, gripper joint range, lift thresholds) must match the
reference's MJCF numerically — they are physics, not code style.
"""

import numpy as np

from .base_cartgripper import BaseCartgripperEnv, zangle_to_quat

# ctrl-target bounds over [x, z, finger]; finger 0 = open, 0.1 = closed
_LOW = (-0.4, -0.075, 0.0)
_HIGH = (0.4, 0.15, 0.1)

# scene/task constants mandated by the MJCF + reference lift rule
_XZ_HPARAMS = dict(
    x_range=0.3,
    default_y=0.0,
    default_theta=0.0,
    gripper_open=0.06438482934440347,   # finger joint qpos at "open"
    gripper_close=0.0,
    gripper_thresh=0.0,
)
_XZ_OVERRIDES = dict(
    filename='cartgripper_xz_grasp.xml',
    mode_rel=[True, True, False],
    finger_sensors=False,
    minlen=0.03,
    maxlen=0.05,
    valid_rollout_floor=-2e-1,
    ncam=1,
)
_LIFT_DELTA = 0.05       # object must rise this far off its floor...
_ARM_MIN_Z = 0.02        # ...while the arm is at least this high
_CLOSED_FRAC = 0.9       # openness below this counts as "gripping"


class CartgripperXZGrasp(BaseCartgripperEnv):
    @staticmethod
    def default_ncam():
        return 1

    def __init__(self, env_params, reset_state=None):
        super().__init__(env_params, reset_state)
        self.low_bound = np.asarray(_LOW)
        self.high_bound = np.asarray(_HIGH)
        self._base_adim, self._base_sdim = 3, 6
        self._adim = self._sdim = 3
        self._gripper_dim = 2
        self._n_joints = 6

    def _default_hparams(self):
        hp = super()._default_hparams()
        for name, value in _XZ_OVERRIDES.items():
            hp.set_hparam(name, value)
        for name, value in _XZ_HPARAMS.items():
            hp.add_hparam(name, value)
        return hp

    # -- state/observation ----------------------------------------------------

    def _openness(self):
        """Gripper openness in [0, 1] (1 = fully open) from the finger qpos."""
        span = self._hp.gripper_open - self._hp.gripper_close
        return 1.0 - (self._data.qpos[4] - self._hp.gripper_close) / span

    def _get_state(self):
        qp = self._data.qpos
        return np.array([qp[0], qp[2], self._openness()])

    def _get_obs(self, finger_sensors):
        obs = super()._get_obs(finger_sensors)
        state = self._get_state()
        obs['state'] = state
        self._last_obs['state'] = state
        return obs

    # -- dynamics -------------------------------------------------------------

    def _snap_ctrl_to_qpos(self, qpos):
        return np.array([qpos[0], qpos[2], 0.0])

    def _init_dynamics(self):
        qp = self._data.qpos
        self._previous_target_qpos = np.array([qp[0], qp[2], 0.0])
        self._goal_reached = False
        self._object_floors = self._last_obs['object_poses_full'].copy()

    def _next_qpos(self, action):
        assert action.shape[0] == self._adim
        closing = action[-1] > self._hp.gripper_thresh
        finger = self.high_bound[-1] if closing else self.low_bound[-1]
        delta = np.array([action[0], action[1], finger])
        return self._previous_target_qpos * self.mode_rel + delta

    def _post_step(self):
        if self._hp.finger_sensors:
            gripping = np.amax(self._last_obs['finger_sensors']) > 0
        else:
            gripping = self._last_obs['state'][2] <= _CLOSED_FRAC
        rises = self._last_obs['object_poses_full'][:, 2] - \
            self._object_floors[:, 2]
        arm_high = self._last_obs['state'][1] >= _ARM_MIN_Z
        if gripping and arm_high and np.amax(rises) >= _LIFT_DELTA:
            self._goal_reached = True

    def has_goal(self):
        return True

    def goal_reached(self):
        return self._goal_reached

    # -- scene randomization --------------------------------------------------

    def _create_pos(self):
        poses = super()._create_pos()
        quat = zangle_to_quat(self._hp.default_theta)
        span = self._hp.x_range
        for pose in poses[:self.num_objects]:
            pose[0] = np.random.uniform(-span, span)
            pose[1] = self._hp.default_y
            pose[3:] = quat
        return poses

    def get_armpos(self, object_pos):
        if not self.randomize_initial_pos:
            raise NotImplementedError
        assert not self.arm_obj_initdist
        return np.array([np.random.uniform(-0.4, 0.4), self._hp.default_y,
                         np.random.uniform(-0.08, 0.14),
                         self._hp.default_theta, 0.0, 0.0])

    # -- benchmark task generation --------------------------------------------

    def generate_task(self):
        self._move_arm()
        self._move_objects()

    def _move_arm(self):
        """Send the arm to a random x and a raised z before object placement."""
        x, z = self._previous_target_qpos[:2]
        dx = np.random.uniform(-self._hp.x_range, self._hp.x_range) - x
        dz = np.random.uniform(0.12, self.high_bound[1]) - z
        self.step(np.array([dx, dz, -1]))

    def _move_objects(self):
        """Create a lifting task by randomly re-placing a block inside the
        gripper until a grasp sticks (no expert available)."""
        i = np.random.choice(self.num_objects)
        base = self._n_joints + i * 7
        wiggle = self._hp.maxlen
        arm_x, arm_z = self._previous_target_qpos[:2]

        while True:
            target_z = arm_z + 0.015 + np.random.uniform(-wiggle, wiggle)
            self._data.qpos[base] = arm_x + np.random.uniform(-wiggle, wiggle)
            self._data.qpos[base + 2] = target_z
            self._sim_step()

            # close on the block while pinning it in place, then settle
            self._hold_ctrl([arm_x, arm_z, self.high_bound[-1]],
                            pin=(base + 2, target_z))
            for _ in range(self.substeps * 5):
                self._sim_step()

            if self._data.qpos[base + 2] > 0.05:
                return
            self._hold_ctrl([arm_x, arm_z, self.low_bound[-1]])

    def _hold_ctrl(self, target, pin=None):
        """Apply a constant ctrl for one macro step, optionally pinning one
        qpos entry (used to keep the block between the fingers mid-close)."""
        for _ in range(self.substeps):
            if pin is not None:
                self._data.qpos[pin[0]] = pin[1]
            self._data.ctrl[:] = np.asarray(target)
            self._sim_step()
