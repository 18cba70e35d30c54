"""Trajectory rollout engine.

Mediates the policy <-> environment loop: runs T control steps, accumulates
every observation stream into fixed-size history buffers (camera frames are
resized down to the agent's operating resolution on ingest), retries
trajectories that fail validity or rejection-sampling checks, and stamps the
metadata the downstream record/benchmark pipeline requires.  Capability
parity with the reference's ``visual_mpc/agent/general_agent.py``; the
implementation is this framework's own.
"""

import copy

import numpy as np

from visual_foresight_torch.policy import get_policy_args
from visual_foresight_torch.utils.im_utils import resize_store
from .utils.file_saver import start_file_worker


class Bad_Traj_Exception(Exception):
    """Raised when every retry of a trajectory failed."""


class Image_Exception(Exception):
    """Raised by camera/render plumbing on a bad frame; triggers a retry."""


class Environment_Exception(Exception):
    """Raised by an env on an unrecoverable step; triggers a retry."""


class _ObsAccumulator:
    """Fixed-capacity per-key history buffers for one rollout.

    ndarray streams get a preallocated ``(T+1, *shape)`` buffer; camera
    frames additionally get resized to the agent resolution on write;
    non-array values are kept in plain lists.  ``view()`` returns the
    history-so-far slice for each key.
    """

    def __init__(self, first_obs, capacity, img_hw):
        self._n = 0
        self._store = {}
        h, w = img_hw
        for key, value in first_obs.items():
            if key == 'images':
                ncam = value.shape[0]
                self._store[key] = np.zeros((capacity, ncam, h, w, 3),
                                            np.uint8)
            elif isinstance(value, np.ndarray):
                self._store[key] = np.zeros((capacity,) + value.shape,
                                            value.dtype)
            else:
                self._store[key] = []

    def push(self, env_obs):
        t = self._n
        for key, value in env_obs.items():
            buf = self._store[key]
            if key == 'images':
                resize_store(t, buf, value)
            elif isinstance(buf, list):
                buf.append(value)
            else:
                buf[t] = value
        self._n += 1

    def view(self):
        return {k: buf[:self._n] for k, buf in self._store.items()}


class GeneralAgent(object):
    """Single chokepoint between algorithms and the environment."""

    def __init__(self, hyperparams, start_saver=True):
        self._hyperparams = hyperparams
        self.T = hyperparams['T']
        self._goal_obj_pose = None
        self._goal_image = None
        self._reset_state = None
        self._is_robot = 'robot_name' in hyperparams['env'][1]
        self._save_worker = start_file_worker() if start_saver else None
        self._setup_world(0)

    # -- world / env lifecycle ---------------------------------------------

    def _setup_world(self, itr):
        env_cls, env_params = self._hyperparams['env']
        old_env = getattr(self, 'env', None)
        if old_env is not None:
            old_env.close()   # free the EGL context before making another
        self.env = env_cls(env_params, self._reset_state)
        # envs own the true dimensionalities; propagate them to the config
        # so savers/policies read consistent values
        self.adim = self._hyperparams['adim'] = self.env.adim
        self.sdim = self._hyperparams['sdim'] = self.env.sdim
        self.ncam = self._hyperparams['ncam'] = self.env.ncam
        self.num_objects = getattr(self.env, 'num_objects', None)

    def _scene_regen_due(self, i_traj):
        """Fresh MuJoCo scene XML every ``gen_xml`` trajectories (or every
        trajectory when the key is absent); robots never regenerate."""
        if self._is_robot or i_traj == 0:
            return False
        every = self._hyperparams.get('gen_xml')
        return True if every is None else i_traj % every == 0

    # -- public entry point --------------------------------------------------

    def sample(self, policy, i_traj):
        """Collect one valid trajectory, retrying up to ``imax`` times.

        :return: (agent_data, obs_dict, policy_outs)
        """
        if self._scene_regen_due(i_traj):
            self._setup_world(i_traj)

        max_attempts = self._hyperparams.get('imax', 100)
        last_exc = None
        for i_trial in range(1, max_attempts + 1):
            if i_trial % 5 == 1 and i_trial > 1 and not self._is_robot:
                # A generated scene can be born bad (object spawned
                # intersecting → ejected through the floor on every reset,
                # failing valid_rollout deterministically).  The reference
                # (visual_mpc/agent/general_agent.py:69-79) retries the same
                # scene imax times and aborts; regenerating every 5 failed
                # trials makes unattended campaigns survive it.
                print('traj {}: {} failed trials; regenerating scene'.format(
                    i_traj, i_trial - 1))
                self._setup_world(i_traj)
            try:
                agent_data, obs_dict, policy_outs = \
                    self.rollout(policy, i_trial, i_traj)
            except (Image_Exception, Environment_Exception) as exc:
                last_exc = exc
                if i_trial % 10 == 0:   # surface persistent faults in the log
                    print('traj {}: {} failed rollouts, last: {!r}'.format(
                        i_traj, i_trial, exc))
                continue
            if agent_data['traj_ok']:
                print('needed {} trials'.format(i_trial))
                return agent_data, obs_dict, policy_outs
        raise Bad_Traj_Exception(
            'traj {}: no valid rollout in {} attempts (last exception: {!r})'
            .format(i_traj, max_attempts, last_exc))

    # -- observation bookkeeping ---------------------------------------------

    def _post_process_obs(self, env_obs, agent_data, initial_obs=False):
        """Ingest one env observation; return the history-so-far dict."""
        img_w = self._hyperparams['image_width']
        if initial_obs:
            self._obs_accum = _ObsAccumulator(
                env_obs, self.T + 1,
                (self._hyperparams['image_height'], img_w))
            if 'obj_image_locations' in env_obs:
                self.traj_points = []

        point_width = float(self._hyperparams.get('point_space_width', img_w))
        if 'images' in env_obs:
            # full-res cam0 frames are kept aside for gif rendering
            self.large_images_traj.append(env_obs['images'][0])
        if 'obj_image_locations' in env_obs:
            self.traj_points.append(
                copy.deepcopy(env_obs['obj_image_locations'][0]))
            # designated points move from raw-render to point-space coords
            raw_width = env_obs['images'].shape[2]
            scaled = env_obs['obj_image_locations'] * point_width / raw_width
            env_obs['obj_image_locations'] = \
                np.round(scaled).astype(np.int64)
            agent_data['desig_pix'] = env_obs['obj_image_locations']

        self._obs_accum.push(env_obs)
        obs = self._obs_accum.view()

        if self._goal_image is not None:
            agent_data['goal_image'] = self._goal_image
        if self._goal_obj_pose is not None:
            agent_data['goal_pos'] = self._goal_obj_pose
            agent_data['goal_pix'] = self.env.get_goal_pix(point_width)
        if self._reset_state is not None:
            agent_data['reset_state'] = self._reset_state
            obs['reset_state'] = self._reset_state
        return obs

    def _required_rollout_metadata(self, agent_data, traj_ok, t, i_traj, i_tr,
                                   reset_state):
        """Metadata MANDATORY for the downstream pipeline: ``term_t``,
        ``goal_reached`` (when the env defines a goal), ``traj_ok``."""
        agent_data['term_t'] = t - 1
        agent_data['traj_ok'] = traj_ok
        if self.env.has_goal():
            agent_data['goal_reached'] = self.env.goal_reached()
        if self._hyperparams.get('save_reset_data', False):
            agent_data['reset_state'] = reset_state
        if 'make_final_recording' in self._hyperparams and \
                self._save_worker is not None:
            self._save_worker.put(('path', self.record_path))
            self.env.save_recording(self._save_worker, i_traj)

    # -- the rollout loop -----------------------------------------------------

    def _early_reject(self, i_trial):
        """Mid-rollout rejection (``rejection_end_early``): abandon as soon
        as the goal check fails while rejection budget remains."""
        if 'rejection_end_early' not in self._hyperparams:
            return False
        return self._hyperparams.get('rejection_sample', 0) > i_trial and \
            not self.env.goal_reached()

    def rollout(self, policy, i_trial, i_traj):
        """Run the policy for T steps.

        :return: (agent_data, obs history dict, list of per-step policy
            outputs).  Record savers assume every value in these is an
            ndarray or a primitive.
        """
        self._init()
        agent_data, policy_outputs = {}, []

        first_obs, reset_state = self.env.reset()
        obs = self._post_process_obs(first_obs, agent_data, initial_obs=True)
        policy.reset()

        t = 0
        while t < self.T:
            pi_t = policy.act(
                **get_policy_args(policy, obs, t, i_traj, agent_data))
            policy_outputs.append(pi_t)
            env_obs = self.env.step(copy.deepcopy(pi_t['actions']))
            obs = self._post_process_obs(env_obs, agent_data)
            t += 1
            if 'rejection_sample' in self._hyperparams and \
                    self._early_reject(i_trial):
                print('traj rejected!')
                return {'traj_ok': False}, None, None

        traj_ok = self.env.valid_rollout()
        if 'rejection_sample' in self._hyperparams:
            if self._hyperparams['rejection_sample'] > i_trial:
                assert self.env.has_goal(), \
                    'rejection sampling requires a goal'
                traj_ok = self.env.goal_reached()
            print('goal_reached', self.env.goal_reached())

        self._required_rollout_metadata(agent_data, traj_ok, t, i_traj,
                                        i_trial, reset_state)
        return agent_data, obs, policy_outputs

    def _init(self):
        self.large_images_traj, self.traj_points = [], None

    def cleanup(self):
        if self._save_worker is not None:
            print('Cleaning up file saver....')
            self._save_worker.close()
            self._save_worker = None

    @property
    def record_path(self):
        return self._hyperparams['data_save_dir'] + '/record/'
