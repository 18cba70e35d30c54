"""Autograsp cartgripper environment.

The policy commands a 4-dim xyz+theta delta; the grip DOF is driven by the
autograsp latch (``envs/util/action_util.py``) instead of the action vector.
Success = any object lifted clear of its resting height.  Capability parity
with the reference's ``cartgripper_env/autograsp_env.py``.
"""

import copy

import numpy as np

from visual_foresight_torch.envs.util.action_util import autograsp_dynamics
from .cartgripper_rot_grasp import CartgripperRotGraspEnv

# object-height deltas (meters) over the resting pose
_GRASP_DETECT_LIFT = 0.01   # some object has left the ground -> hold the grip
_GOAL_LIFT = 0.05           # clearly lifted -> trajectory succeeded


class AutograspCartgripperEnv(CartgripperRotGraspEnv):
    def __init__(self, env_params, reset_state=None):
        if 'mode_rel' in env_params:
            raise AssertionError('autograsp sets mode_rel')
        params = copy.deepcopy(env_params)
        # configs may nest the autograsp knobs one level down
        params.update(params.pop('autograsp', {}))
        super().__init__(params, reset_state)
        self._adim = 4
        self._goal_reached = False
        self._ground_zs = None

    def _default_hparams(self):
        hp = super()._default_hparams()
        hp.set_hparam('finger_sensors', True)
        hp.set_hparam('ncam', 2)
        for name, default in (('no_motion_goal', False),
                              ('reopen', False),
                              ('zthresh', -0.06),
                              ('touchthresh', 0.0),
                              ('lift_height', 0.01)):
            hp.add_hparam(name, default)
        return hp

    def _object_lift(self):
        """Max object height gain over the episode's resting heights."""
        heights = self._last_obs['object_poses_full'][:, 2]
        return np.amax(heights - self._ground_zs)

    def _init_dynamics(self):
        super()._init_dynamics()
        self._goal_reached = False
        self._gripper_closed = False
        self._ground_zs = self._last_obs['object_poses_full'][:, 2].copy()

    def _next_qpos(self, action):
        assert action.shape[0] == self._adim
        holding = self._object_lift() > _GRASP_DETECT_LIFT
        # the latch emits ctrl-space commands directly (this gripper's ctrl
        # range, not the reference's normalized +/-1)
        target, self._gripper_closed = autograsp_dynamics(
            self._previous_target_qpos, action, self._gripper_closed,
            gripper_zpos=self._previous_target_qpos[2],
            zthresh=self._hp.zthresh, reopen=self._hp.reopen,
            grasp_condition=holding,
            open_action=self.low_bound[-1],
            close_action=self.high_bound[-1])
        return target

    def _post_step(self):
        if self._object_lift() > _GOAL_LIFT:
            self._goal_reached = True

    def has_goal(self):
        return True

    def goal_reached(self):
        return self._goal_reached
