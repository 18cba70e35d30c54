"""Goal-definition strategies for benchmark rollouts.

A benchmark rollout needs three things before the episode starts: a scene
``reset_state`` (sim only), a goal image stack, and/or a goal object pose.
The reference interleaves the two ways of obtaining them — replaying a saved
trajectory folder in sim vs. interactively defining goals on a robot —
inside one agent class (``visual_mpc/agent/benchmarking_agent.py:49-139``).
Here each acquisition mode is a small strategy object with a uniform
``GoalSpec`` result, so the agent stays a thin orchestrator and each source
is independently testable.

Hyperparameter surface (unchanged from the reference):
``start_goal_confs``, ``iex``, ``num_load_steps``, ``ntask``,
``no_goal_def``, ``register_gtruth``, ``goal_image_only``,
``load_goal_image``, ``_bench_save``.  OpenCV is imported where an image
is read.
"""

import os
import pickle as pkl
import shutil
from collections import namedtuple

import numpy as np

from visual_foresight_torch.utils.im_utils import resize_store

#: Everything a benchmark episode needs before it starts.  ``save_path`` is
#: where the verbose/planner artifacts for this episode should be routed.
GoalSpec = namedtuple(
    'GoalSpec', ['reset_state', 'goal_image', 'goal_obj_pose', 'save_path'])


def _to_float_image(frames, ncam, height, width):
    """Stack ``frames`` (T lists of ncam HxWx3 uint8) into the benchmark goal
    tensor, resizing to the agent resolution when the source differs."""
    out = np.zeros((len(frames), ncam, height, width, 3), dtype=np.uint8)
    for t, stack in enumerate(frames):
        resize_store(t, out, np.asarray(stack))
    return out.astype(np.float32) / 255.


class TrajectoryFolderGoalSource:
    """Sim benchmarks: replay start/goal definitions recorded by a
    ``save_raw_images`` collection run (reference raw layout:
    ``traj_group<g>/traj<i>/{images<cam>/im_<t>.png, agent_data.pkl,
    obs_dict.pkl}`` — ``visual_mpc/agent/utils/raw_saver.py``).

    The goal pose is the object configuration at the END of the stored
    trajectory; the reset state re-creates its exact start scene.
    """

    GROUP_SIZE = 1000

    def __init__(self, hyperparams, ncam):
        self._hp = hyperparams
        self._ncam = ncam
        self._root = hyperparams['start_goal_confs']

    def _traj_folder(self, itr):
        return os.path.join(self._root,
                            'traj_group%d' % (itr // self.GROUP_SIZE),
                            'traj%d' % itr)

    def _read_frames(self, folder, num_steps):
        import cv2
        for t in range(num_steps):
            stack = []
            for cam in range(self._ncam):
                path = os.path.join(folder, 'images%d' % cam, 'im_%d.png' % t)
                if not os.path.isfile(path):
                    raise ValueError("can't find goal image: %s" % path)
                stack.append(cv2.imread(path)[..., ::-1])
            yield stack

    def load(self, itr):
        itr = self._hp.get('iex', itr)
        folder = self._traj_folder(itr)
        print('reading from: ', folder)

        frames = list(self._read_frames(
            folder, self._hp.get('num_load_steps', 2)))
        goal_image = _to_float_image(frames, self._ncam,
                                     self._hp['image_height'],
                                     self._hp['image_width'])

        with open(os.path.join(folder, 'agent_data.pkl'), 'rb') as f:
            reset_state = pkl.load(f)['reset_state']
        with open(os.path.join(folder, 'obs_dict.pkl'), 'rb') as f:
            goal_obj_pose = pkl.load(f)['object_qpos'][-1]

        verbose_dir = os.path.join(self._hp['data_save_dir'],
                                   'verbose', 'traj_%d' % itr)
        return GoalSpec(reset_state, goal_image, goal_obj_pose, verbose_dir)


class InteractiveRobotGoalSource:
    """Robot benchmarks: the operator defines the goal live through the env
    (designated pixels, a goal image capture, or a pre-saved image file) and
    confirms it before the rollout starts.  Needs the live env, so goals are
    acquired at episode init, not at world setup."""

    def __init__(self, hyperparams, ncam):
        self._hp = hyperparams
        self._ncam = ncam
        if '_bench_save' not in hyperparams:
            raise ValueError(
                'benchmark dir missing — did you pass --benchmark?')
        self._save_dir = hyperparams['_bench_save']

    def _fresh_save_dir(self):
        if os.path.exists(self._save_dir):
            shutil.rmtree(self._save_dir)
        os.makedirs(self._save_dir)

    def _image_goal(self, frames):
        """``frames``: one (ncam, H, W, 3) uint8 stack -> (1, ncam, h, w, 3)
        float goal tensor at the agent resolution."""
        return _to_float_image([frames], self._ncam,
                               self._hp['image_height'],
                               self._hp['image_width'])

    def _acquire_once(self, env):
        """One goal-definition attempt; returns (goal_image, goal_obj_pose)."""
        ntasks = self._hp.get('ntask', 1)
        if 'no_goal_def' not in self._hp:
            # designated-pixel goal; two-stage registration also captures
            # the goal frame (reference register_gtruth_controller.py)
            if len(self._hp.get('register_gtruth', ())) == 2:
                raw, pose = env.get_obj_desig_goal(
                    self._save_dir, True, ntasks=ntasks)
                return self._image_goal(np.asarray(raw)), pose
            return None, env.get_obj_desig_goal(self._save_dir, ntasks=ntasks)
        if 'goal_image_only' in self._hp:
            raw = env.get_goal_image(self._save_dir)
            return self._image_goal(np.asarray(raw)), None
        if 'load_goal_image' in self._hp:
            import cv2
            im = cv2.imread(self._hp['load_goal_image'])[..., ::-1]
            return self._image_goal(im[None]), None
        raise NotImplementedError('no goal definition mode configured')

    def define(self, env):
        """Loop goal acquisition until the operator accepts the definition."""
        while True:
            self._fresh_save_dir()
            goal_image, goal_obj_pose = self._acquire_once(env)
            if 'no_goal_def' in self._hp or \
                    'y' in input('Is definition okay? (y/n): '):
                return GoalSpec(None, goal_image, goal_obj_pose,
                                self._save_dir)
