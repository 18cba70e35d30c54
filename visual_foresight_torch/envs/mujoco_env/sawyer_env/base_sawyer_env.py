"""MuJoCo-native Sawyer-workspace environment.

The port's copy of ``visual_foresight_tpu/envs/mujoco_env/sawyer_env/
base_sawyer_env.py``.

Capability replacement for the reference's robosuite-backed ``SawyerEnv``
(``visual_mpc/envs/mujoco_env/sawyer_env/base_sawyer_env.py:11-66``).  The
reference wrapped a full 7-DoF Sawyer behind an IK controller that reduced
the *effective* action space to end-effector deltas: (dx, dy, dz, dyaw,
grip+-1), 5-dim state, two cameras, a bin of N randomly generated objects.
This class realizes the same contract directly with a position-actuated
end-effector in a procedurally generated MuJoCo scene — no IK detour, no
robosuite dependency, identical agent-visible ABI:

- ``adim = sdim = 5``; actions are deltas in x/y/z/yaw, last dim is the
  binary grip command (>0 close, <=0 open)
- arm reset pose drawn uniformly inside the workspace bounds, gripper open
- ``ncam = 2``; obs additionally carry ``eef_pos``/``eef_quat``
- ``valid_rollout()`` is unconditionally True (matches the reference)
"""

from ..cartgripper_env.base_cartgripper import zangle_to_quat
from ..cartgripper_env.cartgripper_rot_grasp import CartgripperRotGraspEnv


class SawyerEnv(CartgripperRotGraspEnv):
    """Sawyer-workspace pick/push env with end-effector position control."""

    def __init__(self, env_params_dict, reset_state=None):
        params = dict(env_params_dict)
        params.setdefault('ncam', 2)
        # xyz/yaw deltas accumulate onto the previous target; the grip
        # command is absolute (binarized in _next_qpos)
        params.setdefault('mode_rel', [True, True, True, True, False])
        super().__init__(params, reset_state)
        self._adim, self._sdim = 5, 5

    def _default_hparams(self):
        hp = super()._default_hparams()
        # the reference env always rendered two views and settled quickly
        hp.set_hparam('ncam', 2)
        hp.set_hparam('skip_first', 20)
        return hp

    def _get_obs(self, finger_sensors):
        obs = super()._get_obs(finger_sensors)
        obs['eef_pos'] = self._data.qpos[:3].copy()
        obs['eef_quat'] = zangle_to_quat(float(self._data.qpos[3]))
        return obs

    def valid_rollout(self):
        return True

    def has_goal(self):
        return False

    @property
    def ncam(self):
        return 2
