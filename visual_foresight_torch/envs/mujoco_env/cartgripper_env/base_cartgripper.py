"""Cartgripper simulation family base.

Re-designed from reference
``visual_mpc/envs/mujoco_env/cartgripper_env/base_cartgripper.py:34-382``:
procedurally generated scenes, substep-interpolated position control, random
object/arm placement with min-distance rejection, and the standard obs dict
(qpos/qvel/state/object poses/images/obj_image_locations/finger sensors).

Control convention (differs deliberately from the reference's buggy state/ctrl
mixing): ``_previous_target_qpos`` always lives in *ctrl space* — the first
``_base_adim`` actuator targets, with gripper dim in [0, 0.1] (0 = open,
0.1 = close).  Substep interpolation is therefore a straight lerp of ctrl.
"""

import copy
import os

import numpy as np

from visual_foresight_torch.envs.mujoco_env.base_mujoco_env import BaseMujocoEnv
from visual_foresight_torch.envs.mujoco_env.util.create_xml import (
    clean_xml, create_object_xml, create_root_xml)

ASSET_BASE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               '..', 'assets')

low_bound = np.array([-0.5, -0.5, -0.08, -np.pi * 2, 0.])
high_bound = np.array([0.5, 0.5, 0.15, np.pi * 2, 0.1])
is_open_thresh = 0.5 * (low_bound[-1] + high_bound[-1])


def zangle_to_quat(zangle):
    """wxyz quaternion for a rotation of ``zangle`` rad about +z."""
    return np.array([np.cos(zangle / 2), 0, 0, np.sin(zangle / 2)])


def quat_to_zangle(quat):
    """z rotation angle from a (w,x,y,z) quaternion with only z rotation."""
    return np.array([np.arctan2(2 * quat[0] * quat[3], 1 - 2 * quat[3] ** 2)])


def quat_angle(quat):
    """Total rotation angle encoded by a (w,x,y,z) quaternion."""
    w = np.clip(abs(float(quat[0])), 0.0, 1.0)
    return 2.0 * np.arccos(w)


class BaseCartgripperEnv(BaseMujocoEnv):
    """Cartgripper env with motion in x, y, z."""

    def __init__(self, env_params_dict, reset_state=None):
        params_dict = copy.deepcopy(env_params_dict)
        # lists don't type-check cleanly in HParams; pop meshes first
        object_meshes = params_dict.pop('object_meshes', None)

        _hp = self._default_hparams()
        for name, value in params_dict.items():
            print('setting param {} to value {}'.format(name, value))
            _hp.set_hparam(name, value)

        base_filename = os.path.join(ASSET_BASE_PATH, _hp.filename)
        friction_params = (_hp.friction, 0.010, 0.0002)
        reset_xml = None
        if reset_state is not None:
            reset_xml = reset_state['reset_xml']
        self._reset_xml = create_object_xml(
            base_filename, _hp.num_objects, _hp.object_mass, friction_params,
            object_meshes, _hp.finger_sensors, _hp.maxlen, _hp.minlen, reset_xml,
            _hp.obj_classname, cube_objs=_hp.cube_objects,
            block_height=_hp.block_height)
        gen_xml = create_root_xml(base_filename)
        super().__init__(gen_xml, _hp)
        if _hp.clean_xml:
            clean_xml(gen_xml)

        self._base_sdim, self._base_adim, self.mode_rel = 3, 3, np.array(_hp.mode_rel)
        self.num_objects, self.skip_first, self.substeps = \
            _hp.num_objects, _hp.skip_first, _hp.substeps
        self.sample_objectpos = _hp.sample_objectpos
        self.object_object_mindist = _hp.object_object_mindist
        self.randomize_initial_pos = _hp.randomize_initial_pos
        self.arm_obj_initdist = _hp.arm_obj_initdist
        self.arm_start_lifted = _hp.arm_start_lifted
        self.finger_sensors = _hp.finger_sensors
        self.object_sensors = object_meshes is not None
        self._previous_target_qpos, self._n_joints = None, 3
        self._hp = _hp

        self._read_reset_state = reset_state
        self.low_bound = np.array([-0.5, -0.5, -0.08])
        self.high_bound = np.array([0.5, 0.5, 0.15])
        self._gripper_dim = None
        self._adim, self._sdim = 3, 3

    def _default_hparams(self):
        default_dict = {
            'verbose': False,
            'filename': 'cartgripper_updown_2cam.xml',
            'num_objects': 1,
            'object_mass': 0.1,
            'friction': 1.0,
            'mode_rel': [True, True, True],
            'object_meshes': None,
            'finger_sensors': False,
            'maxlen': 0.2,
            'minlen': 0.01,
            'preload_obj_dict': None,
            'sample_objectpos': True,
            'object_object_mindist': 0.,
            'randomize_initial_pos': True,
            'arm_obj_initdist': None,
            'xpos0': None,
            'object_pos0': np.array([]),
            'arm_start_lifted': True,
            'skip_first': 40,
            'obj_classname': None,
            'substeps': 500,
            'clean_xml': True,
            'cube_objects': False,
            'block_height': 0.03,
            'valid_rollout_floor': -2e-2,
            'use_vel': False,
        }
        parent_params = super()._default_hparams()
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    # -- stepping ------------------------------------------------------------
    def _step(self, target_qpos):
        assert target_qpos.shape[0] == self._base_adim
        finger_force = np.zeros(2)
        for st in range(self.substeps):
            if self.finger_sensors:
                finger_force += self._data.sensordata[:2].copy()
            alpha = st / (float(self.substeps) - 1)
            self._data.ctrl[:] = alpha * target_qpos + \
                (1.0 - alpha) * self._previous_target_qpos
            self._sim_step()
        finger_force /= self.substeps

        self._previous_target_qpos = target_qpos
        obs = self._get_obs(finger_force)
        self._post_step()
        return obs

    def step(self, action):
        target_qpos = np.clip(self._next_qpos(action), self.low_bound, self.high_bound)
        return self._step(target_qpos)

    def _post_step(self):
        return

    # -- reset ------------------------------------------------------------------
    def _create_pos(self):
        """Rejection-sample object placements at least ``object_object_mindist``
        apart (reference ``base_cartgripper.py:156-183``)."""
        min_dist = self.object_object_mindist if self.object_object_mindist > 0 else 0.
        attempts, poses, max_attempts = 0, [], 3000
        while attempts < max_attempts:
            poses = []
            for i in range(self.num_objects):
                pos = np.random.uniform(-.35, .35, 2)
                if attempts < (max_attempts - 1) and i > 0:
                    if min(np.linalg.norm(pos - p[:2]) for p in poses) < min_dist:
                        break
                ori = zangle_to_quat(np.random.uniform(0, np.pi * 2))
                poses.append(np.concatenate((pos, np.array([0]), ori), axis=0))
            if len(poses) == self.num_objects:
                break
            attempts += 1
        if attempts >= max_attempts - 1:
            print("WARNING: COULDN'T SPACE OBJECTS — MIN_DIST MAY BE TOO HIGH")
        return poses

    def get_armpos(self, object_pos):
        xpos0 = np.zeros(self._base_sdim)
        if self.randomize_initial_pos:
            assert not self.arm_obj_initdist
            xpos0[:2] = np.random.uniform(-.4, .4, 2)
            xpos0[2] = np.random.uniform(-0.08, .14)
        elif self.arm_obj_initdist:
            d = self.arm_obj_initdist
            alpha = np.random.uniform(-np.pi, np.pi)
            xpos0[:2] = object_pos[:2] + np.array([d * np.cos(alpha),
                                                   d * np.sin(alpha)])
            xpos0[2] = np.random.uniform(-0.08, .14)
        else:
            xpos0 = self._read_reset_state['state']
        if self.arm_start_lifted:
            xpos0[2] = 0.14
        return xpos0

    def _snap_ctrl_to_qpos(self, qpos):
        """Actuator targets that hold the arm at ``qpos`` during settling.
        Subclasses with non-identity joint->ctrl maps override this."""
        ctrl = qpos[:self._base_adim].copy()
        if self._gripper_dim is not None:
            ctrl[self._gripper_dim] = 0.0
        return ctrl

    def reset(self, reset_state=None):
        super().reset()
        if reset_state is not None:
            self._read_reset_state = reset_state

        write_reset_state = {'reset_xml': copy.deepcopy(self._reset_xml)}
        self._last_obs = None

        if self._read_reset_state is None:
            object_pos = np.concatenate(self._create_pos())
            xpos0 = self.get_armpos(object_pos)
            qpos = np.concatenate((xpos0, object_pos.flatten()), 0)
        else:
            qpos = self._read_reset_state['qpos_all']

        self._set_state(qpos, np.zeros_like(self._data.qvel))
        write_reset_state['qpos_all'] = qpos

        snap_ctrl = self._snap_ctrl_to_qpos(qpos)
        finger_force = np.zeros(2)
        for _ in range(self.skip_first):
            for _ in range(self.substeps):
                self._data.ctrl[:] = snap_ctrl
                self._sim_step()
                if self.finger_sensors:
                    finger_force += self._data.sensordata[:2].copy()

        self._previous_target_qpos = snap_ctrl.copy()
        reset_obs = self._get_obs(finger_force / self.skip_first / self.substeps)
        if self._read_reset_state is None and not self.valid_rollout():
            # A freshly sampled scene can be born bad: overlapping spawns get
            # ejected through the floor by the contact solver during the
            # settling loop, so every rollout of this placement would fail
            # valid_rollout() after a full (wasted) T-step episode.  Fail the
            # trial now — the agent's retry re-enters reset(), which
            # re-samples placements (and regenerates the XML after 5 fails).
            # Deterministic task replays (reset_state given) skip the check.
            from visual_foresight_torch.agent.general_agent import (
                Environment_Exception)
            raise Environment_Exception('object below floor after reset '
                                        '(born-bad scene)')
        self._init_dynamics()
        self._reset_eval()
        return reset_obs, write_reset_state

    def qpos_reset(self, qpos, qvel):
        self._read_reset_state['qpos_all'] = qpos
        self._read_reset_state['qvel_all'] = qvel
        return self.reset(self._read_reset_state)

    # -- observations --------------------------------------------------------------
    def _get_obs(self, finger_sensors):
        obs, touch_offset = {}, 0
        if self.finger_sensors:
            obs['finger_sensors'] = np.atleast_1d(finger_sensors)
            touch_offset = 2

        obs['qpos'] = self._data.qpos[:self._n_joints].copy().squeeze()
        obs['qpos_full'] = self._data.qpos.copy()
        obs['qvel'] = self._data.qvel[:self._n_joints].copy().squeeze()
        obs['qvel_full'] = self._data.qvel.copy().squeeze()

        if self._hp.use_vel:
            obs['state'] = np.concatenate([self._data.qpos[:self._sdim].copy(),
                                           self._data.qvel[:self._sdim].copy()])
        else:
            obs['state'] = self._data.qpos[:self._sdim].copy().squeeze()

        if self._gripper_dim is not None:
            if self._previous_target_qpos[-1] < is_open_thresh:
                obs['state'][self._gripper_dim] = -1
            else:
                obs['state'][self._gripper_dim] = 1

        obs['object_poses_full'] = np.zeros((self.num_objects, 7))
        obs['object_qpos'] = np.zeros((self.num_objects, 7))
        obs['object_poses'] = np.zeros((self.num_objects, 3))
        for i in range(self.num_objects):
            pos_sen = self._data.sensordata[
                touch_offset + i * 3: touch_offset + (i + 1) * 3].copy()
            fullpose = self._data.qpos[
                i * 7 + self._n_joints:(i + 1) * 7 + self._n_joints].copy().squeeze()
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

    def valid_rollout(self):
        object_zs = self._last_obs['object_poses_full'][:, 2]
        return not np.any(object_zs < self._hp.valid_rollout_floor)

    def _init_dynamics(self):
        raise NotImplementedError

    def _next_qpos(self, action):
        raise NotImplementedError

    def move_arm(self):
        pass

    def move_objects(self):
        """Teleport objects to random positions a fixed distance away; used to
        synthesize start/goal benchmark configurations
        (reference ``base_cartgripper.py:317-361``)."""
        for i in range(self.num_objects):
            base = self._n_joints + i * 7
            curr_pos = self._data.qpos[base:base + 3].copy()
            pos_ok = False
            newpos = curr_pos
            while not pos_ok:
                alpha = np.random.uniform(-np.pi, np.pi)
                d = 0.25
                delta_pos = np.array([d * np.cos(alpha), d * np.sin(alpha), 0.])
                newpos = curr_pos + delta_pos
                pos_ok = not (np.any(newpos[:2] > high_bound[:2]) or
                              np.any(newpos[:2] < low_bound[:2]))
            self._data.qpos[base:base + 3] = newpos
        self._data.qvel[:] = 0.0
        self._forward()

    def snapshot_noarm(self):
        """Render the scene with the arm teleported out of frame."""
        qpos = self._data.qpos.copy()
        qpos[2] -= 10
        self._set_state(qpos, self._data.qvel.copy())
        image = self.render()[0].squeeze()
        qpos[2] += 10
        self._set_state(qpos, self._data.qvel.copy())
        return image

    def current_obs(self):
        finger_force = np.zeros(2)
        if self.finger_sensors:
            finger_force += self._data.sensordata[:2]
        return self._get_obs(finger_force)
