"""Scripted noisy grasp-transport demonstrator for the autograsp cartgripper.

Closed-loop phase controller: approach an object from above, descend below
the autograsp latch threshold (the env closes the gripper,
``envs/util/action_util.py``), lift, carry to a random drop target, place.
One failed grasp triggers a re-approach (retry), producing realistic
recovery data; a per-step epsilon of fully random actions keeps coverage.

Purpose: directed-exploration data collection.  Random 4-dim Gaussian
collection yields ~11 % grasp success in this env (round-4 campaign, see
docs/EVAL.md); the reference compensated with 30-60k-trajectory corpora
(reference ``experiments/robonet`` confs).  On a single-core box the same
success *density* is reached by scripting the demonstrator instead —
the reference ships the same idea for lifting as
``policy/handcrafted/lifting_policy.py`` (xz, open-loop); this is the
closed-loop xy-z-theta transport analogue.

Action space: 4-dim (x, y, z, theta) deltas integrated by the env into a
target qpos; the grip DOF is the env's autograsp latch, NOT commanded here
(reference ``envs/mujoco_env/cartgripper_env/autograsp_env.py:43-52``).

The port's own copy of
``visual_foresight_tpu/policy/handcrafted/grasp_transport_policy.py``.
"""

import numpy as np

from visual_foresight_torch.policy.policy import Policy

_PHASES = ('approach', 'descend', 'bottom', 'lift', 'carry', 'place')


class GraspTransportPolicy(Policy):
    """Noisy scripted pick-and-transport for ``AutograspCartgripperEnv``."""

    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)
        assert ag_params['adim'] == 4, 'autograsp transport requires adim=4'
        self._T = ag_params['T']
        self.reset()

    def _default_hparams(self):
        hp = super()._default_hparams()
        for name, default in (
                ('cruise_z', 0.04),     # approach height (gripper tip clear)
                ('carry_z', 0.10),      # transport height (object lift > goal)
                ('floor_z', -0.08),     # descend target (below the latch thresh)
                ('place_z', -0.04),     # final lowering (above the latch thresh)
                ('xy_step', 0.08),      # per-step |xy| delta cap (matches the
                                        # random campaign: 2*initial_std=0.08)
                ('z_step', 0.09),
                ('theta_step', np.pi / 4),
                ('xy_tol', 0.015),      # approach converged
                ('drop_tol', 0.03),     # carry converged
                ('lift_thresh', 0.015), # object height gain = grasp held
                ('approach_timeout', 8),
                ('descend_timeout', 5),
                ('bottom_dwell', 2),
                ('lift_steps', 3),
                ('max_retries', 1),
                ('align_theta', True),  # align gripper to cube yaw (mod pi/2)
                ('sigma_xy', 0.01),     # per-step exploration noise
                ('sigma_z', 0.01),
                ('sigma_theta', np.pi / 64),
                ('p_rand', 0.1),        # fully random step probability
                ('rand_std', [0.04, 0.04, 0.2, np.pi / 32]),
                ('drop_bound', 0.3),    # drop target in [-b, b]^2
                ('min_transport', 0.2), # drop target at least this far
        ):
            hp.add_hparam(name, default)
        return hp

    def reset(self):
        self._phase = 'approach'
        self._phase_t = 0
        self._retries = 0
        self._obj_idx = None
        self._drop_xy = None
        self._ground_z = None

    def _enter(self, phase):
        assert phase in _PHASES
        self._phase = phase
        self._phase_t = 0

    def _pick_drop_target(self, pick_xy):
        b = self._hp.drop_bound
        for _ in range(100):
            cand = np.random.uniform(-b, b, size=2)
            if np.linalg.norm(cand - pick_xy) >= self._hp.min_transport:
                return cand
        return -np.clip(pick_xy, -b, b)  # degenerate: mirror across origin

    def _theta_err(self, theta, obj_yaw):
        """Shortest signed rotation aligning the fingers to a cube face
        (gripper yaw is equivalent mod pi/2 for a cube)."""
        err = (obj_yaw - theta + np.pi / 4) % (np.pi / 2) - np.pi / 4
        return err

    def _step_noise(self):
        hp = self._hp
        return np.random.normal(size=4) * np.asarray(
            [hp.sigma_xy, hp.sigma_xy, hp.sigma_z, hp.sigma_theta])

    def _advance(self, t, pos, objs, holding):
        """Phase transitions (closed-loop), then the phase's target pose."""
        hp = self._hp
        obj_xy = objs[self._obj_idx, :2]
        xy_err = np.linalg.norm(obj_xy - pos[:2])

        if self._phase == 'approach':
            if (xy_err < hp.xy_tol and pos[2] < hp.cruise_z + 0.03) or \
                    self._phase_t >= hp.approach_timeout:
                self._enter('descend')
        if self._phase == 'descend':
            if pos[2] < hp.floor_z + 0.03 or self._phase_t >= hp.descend_timeout:
                self._enter('bottom')
        if self._phase == 'bottom':
            if self._phase_t >= hp.bottom_dwell:
                self._enter('lift')
        if self._phase == 'lift':
            if self._phase_t >= hp.lift_steps:
                if holding:
                    self._enter('carry')
                elif self._retries < hp.max_retries and t < self._T - 12:
                    self._retries += 1
                    # the object may have been nudged: re-acquire the nearest
                    dists = np.linalg.norm(objs[:, :2] - pos[:2], axis=1)
                    self._obj_idx = int(np.argmin(dists))
                    self._enter('approach')
                else:
                    self._enter('carry')  # failed grasp: wander to the target
        if self._phase == 'carry':
            if np.linalg.norm(self._drop_xy - pos[:2]) < hp.drop_tol or \
                    t >= self._T - 4:
                self._enter('place')

        if self._phase == 'approach':
            return np.array([obj_xy[0], obj_xy[1], hp.cruise_z])
        if self._phase == 'descend':
            return np.array([obj_xy[0], obj_xy[1], hp.floor_z])
        if self._phase == 'bottom':
            return np.array([pos[0], pos[1], hp.floor_z])
        if self._phase == 'lift':
            return np.array([pos[0], pos[1], hp.carry_z])
        if self._phase == 'carry':
            return np.array([self._drop_xy[0], self._drop_xy[1], hp.carry_z])
        return np.array([self._drop_xy[0], self._drop_xy[1], hp.place_z])

    def act(self, t, state, object_poses_full):
        hp = self._hp
        s = state[-1]                       # (5,) x y z theta grip
        objs = object_poses_full[-1]        # (nobj, 7)

        if t == 0:
            self.reset()
            self._obj_idx = int(np.random.randint(objs.shape[0]))
            self._drop_xy = self._pick_drop_target(objs[self._obj_idx, :2])
            self._ground_z = objs[:, 2].copy()

        holding = bool(np.amax(objs[:, 2] - self._ground_z) > hp.lift_thresh)
        target = self._advance(t, s[:3], objs, holding)
        self._phase_t += 1

        if np.random.uniform() < hp.p_rand:
            action = np.random.normal(size=4) * np.asarray(hp.rand_std)
        else:
            delta = target - s[:3]
            caps = np.array([hp.xy_step, hp.xy_step, hp.z_step])
            action = np.empty(4)
            action[:3] = np.clip(delta, -caps, caps)
            if hp.align_theta and self._phase in ('approach', 'descend'):
                # signed z-yaw from the (w,x,y,z) quaternion (cubes spawn flat,
                # so the rotation axis is ~z and 2*atan2(q_z, q_w) is the yaw)
                quat = objs[self._obj_idx, 3:]
                yaw = 2.0 * np.arctan2(quat[3], quat[0])
                action[3] = np.clip(self._theta_err(s[3], yaw),
                                    -hp.theta_step, hp.theta_step)
            else:
                action[3] = 0.0
            action += self._step_noise()
        return {'actions': action}

    def finish(self):
        pass
