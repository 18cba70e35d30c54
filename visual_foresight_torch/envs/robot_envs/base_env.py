"""Real-robot environment (reference ``robot_envs/base_env.py:21-489``).

Wraps a RobotController + N CameraRecorders behind the standard env ABI:
workspace bounds from ``robot_configs.json``, clipped cartesian moves with
gripper commands, camera-desync detection raising ``Image_Exception``,
randomized / neutral resets with periodic object redistribution, and the
interactive click-based eval used for real-robot benchmarks.

The port's copy of ``visual_foresight_tpu/envs/robot_envs/base_env.py``, on
the port's ``BaseEnv`` and ``Image_Exception``.  OpenCV is imported where a
JPEG is written, matplotlib inside ``select_points``: the module imports
without either.  ``close`` stops the cameras' readers.
"""

import copy
import itertools
import json
import logging
import os
import random
import time

import numpy as np

from visual_foresight_torch.agent.general_agent import Image_Exception
from visual_foresight_torch.envs.base_env import BaseEnv
from . import get_controller_class
from .util.camera_recorder import CameraRecorder
from .util.topic_utils import IMTopic
from .util.user_interface import select_points

_log = logging.getLogger('robot_logger')

# qpos layout shared by every robot env: cartesian xyz, wrist yaw, gripper
_QPOS_DIM = 5


def pix_resize(pix, target_width, original_width):
    """Rescale pixel coordinates to a different image width (rounded)."""
    scaled = np.asarray(pix, dtype=np.float32) * \
        (target_width / float(original_width))
    return np.round(scaled).astype(np.int64)


def _camera_names(n):
    if n <= 2:
        return ['front', 'left'][:n]
    return ['cam{}'.format(i) for i in range(n)]


class BaseRobotEnv(BaseEnv):
    """Controller + camera glue behind the sim-identical env ABI.

    Subclass contract (used by Vanilla/Autograsp envs): override
    ``_next_qpos`` (action -> absolute target qpos) and optionally
    ``_init_dynamics`` (per-rollout state); read ``_previous_target_qpos``,
    ``_low_bound`` / ``_high_bound``, ``_base_adim`` / ``_base_sdim`` and
    ``_last_obs``; state ``ACTION_DIM`` / ``STATE_DIM``.
    """
    # the action and state widths of a subclass, which a planner reads
    # before any robot is connected
    ACTION_DIM = STATE_DIM = None
    # the cameras of an env config that names none
    DEFAULT_CAMERA_TOPICS = (IMTopic('/camera0/image_raw', flip=True),
                             IMTopic('/camera1/image_raw'))

    def __init__(self, env_params, _=None):
        self._hp = self._default_hparams()
        self._hp.start_state = []
        self._apply_overrides(env_params)
        self.savedir = None
        if self._hp.action_space != 'xyz_yaw_gripper':
            raise AssertionError(
                'only xyz_yaw_gripper action spaces supported')

        logging.info('initializing environment for %s', self._hp.robot_name)
        self._robot_name = self._hp.robot_name
        self._setup_robot()
        self._obs_tol = 0.5 if self._hp.opencv_tracking else self._hp.OFFSET_TOL
        self._connect_controller()
        self._exercise_gripper()
        self._connect_cameras()

        self._base_adim = self._base_sdim = _QPOS_DIM
        self._adim, self._sdim = self.ACTION_DIM, self.STATE_DIM
        self.mode_rel = np.array(self._hp.mode_rel)
        self._cleanup_rate = self._hp.cleanup_rate
        self._duration = self._hp.duration
        self._reset_counter = 0
        self._previous_target_qpos = None
        self._start_pix = self._desig_pix = self._goal_pix = None
        self._last_obs = None

        self._goto_closest_neutral(duration=3)

    # -- construction helpers ------------------------------------------------

    def _apply_overrides(self, env_params):
        # robot_type may be a controller CLASS (tests / unregistered robots),
        # and camera_topics / start_state carry non-primitive values hparams
        # would reject — those three bypass set_hparam.
        raw = ('camera_topics', 'start_state', 'robot_type')
        for name, value in env_params.items():
            if name in raw:
                setattr(self._hp, name, value)
            else:
                self._hp.set_hparam(name, value)

    def _connect_controller(self):
        controller_cls = get_controller_class(self._hp.robot_type)
        self._controller = controller_cls(
            self._robot_name, self._hp.print_debug,
            email_cred_file=self._hp.email_login_creds,
            log_file=self._hp.log_file,
            gripper_attached=self._hp.gripper_attached)
        _log.info('-' * 75)
        for name, value in self._hp.values().items():
            _log.info('%s = %s', name, value)
        _log.info('-' * 75)

    def _connect_cameras(self):
        self._save_video = self._hp.save_video
        self._cameras = [
            CameraRecorder(t, self._hp.opencv_tracking, self._save_video)
            for t in self._hp.camera_topics]

        if not self._cameras:
            raise AssertionError('no cameras configured')
        dims = {(c.img_height, c.img_width) for c in self._cameras}
        if len(dims) != 1:
            raise AssertionError('camera image streams do not match')
        self._height, self._width = dims.pop()
        self._cam_names = _camera_names(len(self._cameras))

    def _exercise_gripper(self):
        """Open/close/open cycle: verifies the gripper responds and leaves it
        in the known-open state before the first reset."""
        self._controller.open_gripper(True)
        self._controller.close_gripper(True)
        self._controller.open_gripper(True)

    def _default_hparams(self):
        default_dict = {
            'robot_name': None,
            'robot_type': 'sawyer',
            'email_login_creds': '',
            'log_file': '',
            'gripper_attached': 'wsg-50',
            'camera_topics': list(self.DEFAULT_CAMERA_TOPICS),
            'opencv_tracking': False,
            'save_video': False,
            'start_at_neutral': False,
            'start_box': [1., 1., 1.],
            'OFFSET_TOL': 0.06,
            'duration': 1.,
            'mode_rel': [True, True, True, True, False],
            'lower_bound_delta': [0., 0., 0., 0., 0.],
            'upper_bound_delta': [0., 0., 0., 0., 0.],
            'cleanup_rate': 25,
            'print_debug': False,
            'rand_drop_reset': True,
            'normalize_actions': False,
            'reset_before_eval': False,
            'action_space': 'xyz_yaw_gripper',
            'wait_during_resetend': False,
        }
        parent_params = BaseEnv._default_hparams(self)
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    def _setup_robot(self):
        """Load per-robot workspace bounds (+ configured deltas) from the
        JSON registry next to this module."""
        config_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   'robot_configs.json')
        try:
            with open(config_file) as f:
                bounds = json.load(f)[self._robot_name]
        except (ValueError, FileNotFoundError):
            raise ValueError(
                'fill out the robot config at {}'.format(config_file))
        except KeyError:
            raise ValueError('robot {} missing from config {}'.format(
                self._robot_name, config_file))
        lo, hi = (np.array(b, dtype=np.float64) for b in bounds)
        self._low_bound = lo + np.asarray(self._hp.lower_bound_delta,
                                          dtype=np.float64)
        self._high_bound = hi + np.asarray(self._hp.upper_bound_delta,
                                           dtype=np.float64)

    # -- workspace geometry ---------------------------------------------------

    @property
    def _xyz_span(self):
        return self._high_bound[:3] - self._low_bound[:3]

    def _normalized_to_workspace(self, unit_xyz):
        """Map [0,1]^3 coordinates into workspace xyz."""
        return np.asarray(unit_xyz) * self._xyz_span + self._low_bound[:3]

    def _random_pose(self):
        """Uniform (xyz, yaw) draw over the workspace."""
        draw = np.random.uniform(self._low_bound[:4], self._high_bound[:4])
        return draw[:3], draw[3]

    @property
    def _gripper_midpoint(self):
        return 0.5 * (self._low_bound[-1] + self._high_bound[-1])

    # -- stepping -------------------------------------------------------------

    def step(self, action):
        if self._hp.normalize_actions:
            action[:3] *= self._xyz_span

        target_qpos = np.clip(self._next_qpos(action), self._low_bound,
                              self._high_bound)
        _log.debug('target position: %s', target_qpos)
        if np.linalg.norm(target_qpos - self._previous_target_qpos) < 1e-3:
            return self._get_obs()  # no-op command: skip the move entirely

        with self._recording():
            self._command_gripper(target_qpos[-1])
            self._move_to_state(target_qpos[:3], target_qpos[3])
        self._previous_target_qpos = target_qpos
        return self._get_obs()

    def _command_gripper(self, gripper_qpos):
        """Send the discrete open/close command; block only when the command
        crosses the midpoint (i.e. the state actually changes)."""
        closing = gripper_qpos > self._gripper_midpoint
        was_closing = self._previous_target_qpos[-1] > self._gripper_midpoint
        wait = closing != was_closing
        if closing:
            self._controller.close_gripper(wait)
        else:
            self._controller.open_gripper(wait)

    def _recording(self):
        """Context manager: camera video capture around a motion (no-op when
        save_video is off)."""
        cameras = self._cameras if self._save_video else []

        class _Rec:
            def __enter__(_self):
                for c in cameras:
                    c.start_recording()

            def __exit__(_self, *exc):
                for c in cameras:
                    c.stop_recording()
                return False
        return _Rec()

    def _init_dynamics(self):
        pass

    def _next_qpos(self, action):
        raise NotImplementedError

    # -- observations ---------------------------------------------------------

    def _get_state(self):
        """Normalized 5-dim proprioceptive state: xyz in workspace fraction,
        wrist yaw, gripper reading mapped onto [low, high] bound units."""
        eep = self._controller.get_cartesian_pose()
        grip = self._controller.get_gripper_state()[0]
        g_low, g_high = self._controller.get_gripper_limits()
        if g_high > g_low:
            grip = (grip - g_low) / (g_high - g_low)
        xyz_frac = (eep[:3] - self._low_bound[:3]) / self._xyz_span
        yaw = self._controller.quat_2_euler(eep[3:])[0]
        grip_qpos = self._low_bound[-1] + grip * \
            (self._high_bound[-1] - self._low_bound[-1])
        return np.concatenate([xyz_frac, [yaw, grip_qpos]])

    def _get_obs(self):
        j_angles, j_vel, _ = self._controller.get_state()
        gripper_state, force_sensor = self._controller.get_gripper_state()

        obs = {'qpos': j_angles, 'state': self._get_state()}
        if j_vel is not None:   # widowx has no joint velocity readings
            obs['qvel'] = j_vel
        if force_sensor is not None:
            obs['finger_sensors'] = force_sensor

        self._last_obs = copy.deepcopy(obs)
        obs['images'] = self.render()
        obs['high_bound'] = self._high_bound.copy()
        obs['low_bound'] = self._low_bound.copy()

        if self._hp.opencv_tracking:
            self._desig_pix = np.stack(
                [c.get_track() for c in self._cameras]).astype(np.int64)
        if self._desig_pix is not None:
            obs['obj_image_locations'] = copy.deepcopy(self._desig_pix)
        return obs

    def _move_to_state(self, target_xyz, target_zangle, duration=1.5):
        quat = self._controller.euler_2_quat(target_zangle)
        self._controller.move_to_eep(np.concatenate((target_xyz, quat)),
                                     duration)

    def _reset_previous_qpos(self):
        xyz, quat = self._controller.get_xyz_quat()
        yaw = self._controller.quat_2_euler(quat)[0]
        self._previous_target_qpos = np.concatenate([xyz, [yaw, -1.0]])

    def save_recording(self, save_worker, i_traj):
        if not self._save_video:
            return
        buffers = [c.reset_recording() for c in self._cameras]
        if not any(len(b) for b in buffers):
            return
        for name, frames in zip(self._cam_names, buffers):
            save_worker.put(('mov', 'recording{}/{}_clip.mp4'.format(
                i_traj, name), frames, 30))

    # -- resets ---------------------------------------------------------------

    def _end_reset(self):
        start_image = self.render()
        if self.savedir is not None:
            import cv2
            cv2.imwrite('{}/initial_image.jpg'.format(self.savedir),
                        start_image[0][:, :, ::-1])
        _log.info('finishing reset %d', self._reset_counter)
        if self._hp.wait_during_resetend:
            input('PRESS ENTER TO CONTINUE')
        if self._hp.opencv_tracking:
            if self._desig_pix is None:
                raise AssertionError(
                    'designated pixels must be set (call get_obj_desig_goal)')
            track = copy.deepcopy(self._desig_pix)
            for cam, pts in zip(self._cameras, track):
                cam.start_tracking(pts)
        self._reset_previous_qpos()
        self._init_dynamics()
        self._reset_counter += 1
        return self._get_obs(), None

    def _goto_closest_neutral(self, duration=2.):
        self._controller.move_to_neutral(duration)
        neutral = self._get_state()
        boxed = np.clip(neutral[:3], 0.0, self._hp.start_box)
        self._move_to_state(self._normalized_to_workspace(boxed), neutral[3])

    def _drop_reset(self):
        """Carry whatever is grasped to a random pose at max height, drop it
        (close+open), then retreat to neutral — scatters objects between
        rollouts without human help."""
        xyz, yaw = self._random_pose()
        xyz[2] = self._high_bound[2]
        self._move_to_state(xyz, yaw, 2.)
        self._controller.close_gripper(True)
        self._controller.open_gripper(True)
        self._controller.move_to_neutral()

    def _cleanup_due(self):
        rate = self._cleanup_rate
        if rate == 0:
            return True
        return rate > 0 and self._reset_counter > 0 and \
            self._reset_counter % rate == 0

    def reset(self):
        if self._save_video:
            for c in self._cameras:
                c.reset_recording()

        if self._hp.start_at_neutral:
            self._controller.open_gripper(True)
            self._goto_closest_neutral()
            return self._end_reset()

        if self._hp.rand_drop_reset:
            self._drop_reset()
        else:
            self._controller.open_gripper(True)
            self._controller.move_to_neutral()

        if self._cleanup_due():
            self._controller.redistribute_objects()
            self._goto_closest_neutral(5.)

        self._controller.move_to_neutral()
        self._controller.open_gripper(False)
        time.sleep(0.5)
        self._reset_previous_qpos()

        if self._hp.start_state:
            xyz = self._normalized_to_workspace(self._hp.start_state[:3])
            self._move_to_state(xyz, self._hp.start_state[3], 2.)
        else:
            xyz, yaw = self._random_pose()
            self._move_to_state(xyz, yaw, 2.)

        return self._end_reset()

    def valid_rollout(self):
        return True

    def goal_reached(self):
        raise NotImplementedError('Environment has no goal')

    def has_goal(self):
        return False

    # -- rendering ------------------------------------------------------------

    def render(self):
        """Grab frames from all cameras, enforcing freshness and cross-camera
        sync (raises Image_Exception on desync)."""
        now = time.time()
        stamps, frames = [], []
        for recorder in self._cameras:
            stamp, image = recorder.get_image()
            if abs(stamp - now) > 10 * self._obs_tol:
                _log.error('DESYNC: no camera ping in %.1f s',
                           10 * self._obs_tol)
                raise Image_Exception
            stamps.append(stamp)
            frames.append(image)

        for t_i, t_j in itertools.combinations(stamps, 2):
            if abs(t_i - t_j) > self._obs_tol:
                _log.error('DESYNC: cameras out of sync')
                raise Image_Exception

        # cameras deliver BGR; the framework convention is RGB
        return np.stack([f[:, :, ::-1] for f in frames]).astype(np.uint8)

    @property
    def adim(self):
        return self._adim

    @property
    def sdim(self):
        return self._sdim

    @property
    def ncam(self):
        return len(self._cameras)

    @property
    def num_objects(self):
        return 0

    def seed(self, seed=None):
        random.seed(seed)
        np.random.seed(seed)

    def close(self):
        for c in self._cameras:
            c.close()

    # -- interactive benchmarking ----------------------------------------------

    def _safe_neutral(self, confirm=True):
        if confirm:
            input('Robot in safe position? Hit enter when ready...')
        self._goto_closest_neutral()
        self._controller.open_gripper(True)

    def _annotate(self, label, save_dir, ntasks, clicks_per_desig=1):
        return select_points(self.render(), self._cam_names, label, save_dir,
                             clicks_per_desig=clicks_per_desig,
                             n_desig=ntasks)

    def eval(self, target_width=None, save_dir=None, ntasks=None):
        if target_width is None:
            return None
        if self._hp.reset_before_eval:
            self._controller.open_gripper(True)
            self._controller.move_to_neutral()

        final_pix = pix_resize(
            self._annotate('final', save_dir, ntasks), target_width,
            self._width)
        goal_pix = self.get_goal_pix(target_width)
        start_pix = pix_resize(self._start_pix, target_width, self._width)

        final_dist = np.linalg.norm(final_pix - goal_pix)
        start_dist = np.linalg.norm(start_pix - goal_pix)
        _log.info('final_dist: %f start_dist: %f improvement: %f',
                  final_dist, start_dist, start_dist - final_dist)

        if self._hp.opencv_tracking:
            for c in self._cameras:
                c.end_tracking()
        return {'final_dist': final_dist, 'start_dist': start_dist,
                'improvement': start_dist - final_dist}

    def get_obj_desig_goal(self, save_dir, collect_goal_image=False, ntasks=1):
        self._safe_neutral()

        if collect_goal_image:
            print('PLACE OBJECTS IN GOAL POSITION')
            input('When ready to annotate GOAL images press enter...')
            goal_imgs = self.render()
            goal_pix = self._annotate('goal', save_dir, ntasks)
            self._safe_neutral()
            print('PLACE OBJECTS IN START POSITION')
            input('When ready to annotate START images press enter...')
            self._start_pix = self._annotate('desig', save_dir, ntasks)
            self._goal_pix = copy.deepcopy(goal_pix)
            self._desig_pix = copy.deepcopy(self._start_pix)
            return goal_imgs, goal_pix

        print('PLACE OBJECTS IN START POSITION')
        input('When ready to annotate START images press enter...')
        self._start_pix, self._goal_pix = select_points(
            self.render(), self._cam_names, 'desig_goal', save_dir,
            n_desig=ntasks)
        self._desig_pix = copy.deepcopy(self._start_pix)
        return copy.deepcopy(self._goal_pix)

    def get_goal_image(self, savedir):
        self.savedir = savedir
        self._safe_neutral(confirm=False)
        input('hit enter when ready to take goal image')
        goal_img = self.render()
        self._safe_neutral(confirm=False)
        input('hit enter when objects put back')
        import cv2
        cv2.imwrite('{}/goal_image.jpg'.format(savedir),
                    goal_img[0][:, :, ::-1])
        return goal_img

    def get_goal_pix(self, target_width):
        return pix_resize(self._goal_pix, target_width, self._width)
