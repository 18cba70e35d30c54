"""Scripted lifting demonstrator for the xz-grasp task.

Capability parity with the reference's ``policy/handcrafted/lifting_policy.py``:
at t=0 the whole plan is laid out as four phases — slide above a randomly
chosen object, descend to the floor, close the gripper, carry to a random
target — with Gaussian noise added for demonstration diversity.

The port's own copy of
``visual_foresight_tpu/policy/handcrafted/lifting_policy.py``.
"""

import numpy as np

from visual_foresight_torch.policy.policy import Policy


class LiftingPolicy(Policy):
    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)

        if self._hp.action_space != 'xzgrasp':
            raise NotImplementedError
        assert self._hp.nactions >= 5, 'need at least 5 actions'
        assert all(f > 0 for f in self._hp.frac_act) and \
            sum(self._hp.frac_act) <= 1.
        assert ag_params['adim'] == 3, 'xzgrasp requires adim=3'
        self._actions = None

    def _default_hparams(self):
        hp = super()._default_hparams()
        for name, default in (('nactions', 15),
                              ('repeat', 1),
                              ('action_space', 'xzgrasp'),
                              ('frac_act', [0.4, 0.1]),
                              ('sigma', [0.05, 0.1, 0]),
                              ('bounds', [[-0.4, 0.05], [0.4, 0.15]]),
                              ('up_z', 0.15),
                              ('floor_z', -0.075)):
            hp.add_hparam(name, default)
        return hp

    def reset(self):
        self._actions = None

    def _phase_lengths(self):
        """(approach, descend, carry) step counts; grip-close takes 1 step."""
        n_move = self._hp.nactions - 1
        approach, descend = (int(max(np.round(n_move * f), 1))
                             for f in self._hp.frac_act)
        carry = n_move - approach - descend
        assert carry > 0, 'not enough time to move object'
        return approach, descend, carry

    def _build_plan(self, state, object_poses):
        """Lay out the full (nactions, 3) xz+grip plan at control cadence."""
        hp = self._hp
        approach, descend, carry = self._phase_lengths()
        obj_x = object_poses[0, np.random.choice(object_poses.shape[1]), 0]
        drop_x, drop_z = np.random.uniform(low=hp.bounds[0],
                                           high=hp.bounds[1])

        segments = [
            # phase 1: slide over the object while rising to up_z, grip open
            (approach, [(obj_x - state[0, 0]) / approach,
                        (hp.up_z - state[0, 1]) / approach, -1]),
            # phase 2: straight descent to the floor
            (descend, [0, (hp.floor_z - hp.up_z) / descend, -1]),
            # phase 3: close the gripper in place
            (1, [0, 0, 1]),
            # phase 4: carry the object to the drop target
            (carry, [(drop_x - obj_x) / carry,
                     (drop_z - hp.floor_z) / carry, 1]),
        ]
        plan = np.concatenate(
            [np.tile(np.asarray(act, np.float64), (n, 1))
             for n, act in segments], axis=0)
        plan += np.random.normal(size=plan.shape) * np.asarray(hp.sigma)

        # expand to the control cadence; positional deltas split evenly over
        # the repeats, the grip command does not
        plan = np.repeat(plan, hp.repeat, axis=0)
        plan[:, :2] /= hp.repeat
        return plan

    def act(self, t, state, object_poses):
        if self._hp.action_space != 'xzgrasp':
            raise NotImplementedError
        if t == 0:
            self._actions = self._build_plan(state, object_poses)
        return {'actions': self._actions[t].copy()}
