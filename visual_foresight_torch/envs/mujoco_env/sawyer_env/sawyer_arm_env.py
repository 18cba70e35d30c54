"""Visible-arm Sawyer simulation with IK end-effector control.

The port's copy of ``visual_foresight_tpu/envs/mujoco_env/sawyer_env/
sawyer_arm_env.py`` (the same frames and states); ``mujoco`` is imported
when an env is built (``base_mujoco_env.py``).

Fills the round-2 gap vs the reference's robosuite Sawyer
(``visual_mpc/envs/mujoco_env/sawyer_env/base_sawyer_env.py:11-66`` +
``robosuite_wrappers/SawyerIKEnv.py``): a real 7-DoF arm is rendered in
frame, the agent-visible action space is still end-effector deltas
(dx, dy, dz, dyaw, grip), and the conversion to joint targets runs through
the same damped-least-squares IK the physical-robot stack uses
(``envs/robot_envs/sawyer/inverse_kinematics.CHAIN``), seeded with the
current joint state and re-solved along the interpolated Cartesian path each
substep window — the moral equivalent of robosuite's per-substep IK
controller, with zero external dependencies.

Obs dict follows the cartgripper contract (qpos/qvel/state/object_poses/
images/obj_image_locations/finger_sensors) plus ``eef_pos``/``eef_quat``
like the reference Sawyer env.
"""

import copy
import os

import numpy as np

from visual_foresight_torch.envs.mujoco_env.base_mujoco_env import BaseMujocoEnv
from visual_foresight_torch.envs.mujoco_env.cartgripper_env.base_cartgripper import (
    quat_angle, zangle_to_quat)
from visual_foresight_torch.envs.mujoco_env.util.create_xml import (
    clean_xml, create_object_xml, create_root_xml)
from visual_foresight_torch.envs.robot_envs.sawyer.inverse_kinematics import (
    CHAIN, NEUTRAL)
from visual_foresight_torch.envs.robot_envs.util.kinematics import IKError
from .arm_model import BASE_POS, FINGER_RANGE, write_scene_xml

ASSET_BASE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               '..', 'assets')
N_ARM_JOINTS = 7
N_JOINTS = N_ARM_JOINTS + 2       # + two gripper fingers
# agent workspace (world frame), mirroring the reference Sawyer bounds'
# extent re-centered on the bin (reference base_sawyer_env.py:6-7)
low_bound = np.array([-0.3, -0.35, -0.05, -np.pi * 2, -1.0])
high_bound = np.array([0.3, 0.35, 0.25, np.pi * 2, 1.0])


def _quat_down_yaw(yaw):
    """wxyz for Rz(yaw) @ Rx(pi): gripper pointing down, free yaw."""
    half = yaw / 2.0
    return np.array([0.0, np.cos(half), np.sin(half), 0.0])


class SawyerArmEnv(BaseMujocoEnv):
    """Bin arena + rendered 7-DoF Sawyer; (dx, dy, dz, dyaw, grip) actions."""

    def __init__(self, env_params_dict, reset_state=None):
        params_dict = copy.deepcopy(env_params_dict)
        object_meshes = params_dict.pop('object_meshes', None)
        _hp = self._default_hparams()
        for name, value in params_dict.items():
            print('setting param {} to value {}'.format(name, value))
            _hp.set_hparam(name, value)

        base_filename = write_scene_xml(ASSET_BASE_PATH)
        friction_params = (_hp.friction, 0.010, 0.0002)
        reset_xml = reset_state['reset_xml'] if reset_state is not None \
            else None
        self._reset_xml = create_object_xml(
            base_filename, _hp.num_objects, _hp.object_mass, friction_params,
            object_meshes, _hp.finger_sensors, _hp.maxlen, _hp.minlen,
            reset_xml, cube_objs=_hp.cube_objects)
        gen_xml = create_root_xml(base_filename)
        super().__init__(gen_xml, _hp)
        if _hp.clean_xml:
            clean_xml(gen_xml)

        self.num_objects = _hp.num_objects
        self.finger_sensors = _hp.finger_sensors
        self.substeps = _hp.substeps
        self.skip_first = _hp.skip_first
        self.randomize_initial_pos = _hp.randomize_initial_pos
        self.mode_rel = np.array(_hp.mode_rel)
        self._n_joints = N_JOINTS
        self._adim = self._sdim = 5
        self.low_bound, self.high_bound = low_bound, high_bound
        self._read_reset_state = reset_state
        self._rng = np.random.RandomState()
        # (x, y, z, yaw, grip in {-1, 1}) — the integrated EE target
        self._target_pose = None
        self._q_cmd = NEUTRAL.copy()

    def _default_hparams(self):
        defaults = {
            'num_objects': 1,
            'object_mass': 0.5,
            'friction': 1.0,
            'finger_sensors': True,
            'maxlen': 0.06,
            'minlen': 0.01,
            'cube_objects': False,
            'object_meshes': None,
            'object_object_mindist': 0.0,
            'randomize_initial_pos': True,
            'mode_rel': [True, True, True, True, False],
            'substeps': 200,
            'ik_updates': 10,     # IK re-solves per env step
            'skip_first': 15,
            'clean_xml': True,
            # the bin table top sits at z=-0.05 (arm_model.py container), so
            # resting cubes center below the cartgripper convention's z=0;
            # the check should trip only when an object leaves the bin
            'valid_rollout_floor': -8e-2,
        }
        parent_params = super()._default_hparams()
        parent_params.set_hparam('ncam', 2)
        for k, v in defaults.items():
            parent_params.add_hparam(k, v)
        return parent_params

    # -- kinematics helpers ----------------------------------------------------------
    def _solve_ik(self, xyz_world, yaw, seed):
        """World target -> joint vector; DLS with restart ladder (seed, then
        neutral, then randomized neutrals) since a single far seed can stall
        on the down-pointing wrist configuration."""
        target = np.asarray(xyz_world) - BASE_POS
        quat = _quat_down_yaw(yaw)
        seeds = [seed, NEUTRAL]
        for _ in range(3):
            seeds.append(CHAIN.clip(NEUTRAL + self._rng.randn(7) * 0.7))
        for s in seeds:
            try:
                return CHAIN.ik(target, quat, seed=s, nullspace_goal=NEUTRAL)
            except IKError:
                continue
        return None   # hold the previous command this window

    def _ee_world(self, q=None):
        q = self._data.qpos[:N_ARM_JOINTS] if q is None else q
        pose = CHAIN.fk_pose(q)
        return pose[:3] + BASE_POS, pose[3:]

    def _finger_ctrl(self, grip):
        return 0.0 if grip > 0 else FINGER_RANGE   # 0 = closed

    # -- stepping --------------------------------------------------------------------
    def _servo(self, pose_from, pose_to, collect_touch=True):
        """Drive the arm along the Cartesian segment, re-solving IK every
        substep window; returns the mean finger force."""
        hp = self._hp
        finger_force = np.zeros(2)
        window = max(self.substeps // hp.ik_updates, 1)
        for st in range(self.substeps):
            if st % window == 0:
                alpha = min((st + window) / float(self.substeps), 1.0)
                pose = (1.0 - alpha) * pose_from + alpha * pose_to
                q = self._solve_ik(pose[:3], pose[3], self._q_cmd)
                if q is not None:
                    self._q_cmd = q
            self._data.ctrl[:N_ARM_JOINTS] = self._q_cmd
            self._data.ctrl[N_ARM_JOINTS:N_JOINTS] = \
                self._finger_ctrl(pose_to[4])
            # gravity/Coriolis compensation on the arm dofs: the position
            # actuators then only fight tracking error, not the ~kg links'
            # weight (P-only control would otherwise droop centimetres)
            self._data.qfrc_applied[:N_JOINTS] = \
                self._data.qfrc_bias[:N_JOINTS]
            self._sim_step()
            if self.finger_sensors and collect_touch:
                finger_force += self._data.sensordata[:2]
        return finger_force / self.substeps

    def step(self, action):
        action = np.asarray(action, np.float64)
        assert action.shape[0] == self._adim
        prev = self._target_pose.copy()
        target = np.where(self.mode_rel, prev + action, action)
        target[4] = 1.0 if action[4] > 0 else -1.0
        target = np.clip(target, low_bound, high_bound)
        finger_force = self._servo(prev, target)
        self._target_pose = target
        obs = self._get_obs(finger_force)
        return obs

    # -- reset -----------------------------------------------------------------------
    def _sample_object_qpos(self):
        poses = []
        mindist = self._hp.object_object_mindist
        for attempt in range(3000):
            poses = []
            for i in range(self.num_objects):
                pos = self._rng.uniform(-.35, .35, 2)
                if mindist and i > 0 and attempt < 2999 and \
                        min(np.linalg.norm(pos - p[:2]) for p in poses) < mindist:
                    break
                quat = zangle_to_quat(self._rng.uniform(0, 2 * np.pi))
                poses.append(np.concatenate([pos, [0.0], quat]))
            if len(poses) == self.num_objects:
                break
        return np.concatenate(poses) if poses else np.zeros(0)

    def reset(self, reset_state=None):
        super().reset()
        if reset_state is not None:
            self._read_reset_state = reset_state
        write_reset_state = {'reset_xml': copy.deepcopy(self._reset_xml)}

        if self._read_reset_state is None:
            if self.randomize_initial_pos:
                start = np.array([
                    self._rng.uniform(low_bound[0], high_bound[0]),
                    self._rng.uniform(low_bound[1], high_bound[1]),
                    self._rng.uniform(0.12, high_bound[2]),
                    self._rng.uniform(0, 2 * np.pi), -1.0])
            else:
                start = np.array([0.0, 0.0, 0.2, 0.0, -1.0])
            q0 = self._solve_ik(start[:3], start[3], NEUTRAL)
            if q0 is None:
                q0 = NEUTRAL.copy()
            qpos = np.concatenate([q0, [FINGER_RANGE, FINGER_RANGE],
                                   self._sample_object_qpos()])
            self._target_pose = start
        else:
            qpos = self._read_reset_state['qpos_all']
            self._target_pose = self._read_reset_state['state'].copy()
            q0 = qpos[:N_ARM_JOINTS]
        write_reset_state['qpos_all'] = qpos
        write_reset_state['state'] = self._target_pose.copy()

        self._set_state(qpos, np.zeros_like(self._data.qvel))
        self._q_cmd = qpos[:N_ARM_JOINTS].copy()

        # settle: hold the start pose while objects land
        finger_force = np.zeros(2)
        for _ in range(self.skip_first):
            finger_force += self._servo(self._target_pose, self._target_pose,
                                        collect_touch=True)
        self._init_dynamics()
        self._reset_eval()
        return self._get_obs(finger_force / max(self.skip_first, 1)), \
            write_reset_state

    def _init_dynamics(self):
        pass

    # -- observations ----------------------------------------------------------------
    def _get_obs(self, finger_sensors):
        obs, touch_offset = {}, 0
        if self.finger_sensors:
            obs['finger_sensors'] = np.atleast_1d(np.sum(finger_sensors))
            touch_offset = 2

        obs['qpos'] = self._data.qpos[:self._n_joints].copy()
        obs['qpos_full'] = self._data.qpos.copy()
        obs['qvel'] = self._data.qvel[:self._n_joints].copy()
        obs['qvel_full'] = self._data.qvel.copy()

        eef_pos, eef_quat = self._ee_world()
        grip = self._target_pose[4] if self._target_pose is not None else -1.0
        obs['state'] = np.concatenate(
            [eef_pos, [self._target_pose[3] if self._target_pose is not None
                       else 0.0, grip]])
        obs['eef_pos'], obs['eef_quat'] = eef_pos, eef_quat

        obs['object_poses_full'] = np.zeros((self.num_objects, 7))
        obs['object_qpos'] = np.zeros((self.num_objects, 7))
        obs['object_poses'] = np.zeros((self.num_objects, 3))
        for i in range(self.num_objects):
            pos_sen = self._data.sensordata[
                touch_offset + i * 3: touch_offset + (i + 1) * 3].copy()
            fullpose = self._data.qpos[
                i * 7 + self._n_joints:(i + 1) * 7 + self._n_joints].copy()
            fullpose[:3] = pos_sen
            obs['object_poses_full'][i] = fullpose
            obs['object_poses'][i, :2] = pos_sen[:2]
            obs['object_poses'][i, 2] = quat_angle(fullpose[3:])
            obs['object_qpos'][i] = self._data.qpos[
                self._n_joints + i * 7: self._n_joints + (i + 1) * 7].copy()

        self._last_obs = copy.deepcopy(obs)
        obs['images'] = self.render()
        obs['obj_image_locations'] = self.get_desig_pix(
            self._frame_width, obj_poses=obs['object_poses_full'])
        return obs

    def current_obs(self):
        return self._get_obs(np.zeros(2))

    def valid_rollout(self):
        object_zs = self._last_obs['object_poses_full'][:, 2]
        return not np.any(object_zs < self._hp.valid_rollout_floor)

    def has_goal(self):
        return False

    def snapshot_noarm(self):
        """Render with the arm folded out of frame (for goal images)."""
        qpos = self._data.qpos.copy()
        saved = qpos[:N_ARM_JOINTS].copy()
        qpos[:N_ARM_JOINTS] = CHAIN.clip(np.array([np.pi, -1.5, 0, 0, 0, 0, 0]))
        self._set_state(qpos, self._data.qvel.copy())
        image = self.render()[0]
        qpos[:N_ARM_JOINTS] = saved
        self._set_state(qpos, self._data.qvel.copy())
        return image
