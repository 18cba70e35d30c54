"""Benchmark agent: a :class:`GeneralAgent` whose episodes start from a
goal definition instead of a random scene.

Capability of reference ``visual_mpc/agent/benchmarking_agent.py``; the
hyperparameter surface and the rollout hooks are the compatibility ABI
(benchmark configs under ``benchmarks/`` and ``experiments/`` construct this
class by name with the reference's keys).  The goal-acquisition logic itself
lives in :mod:`visual_foresight_torch.agent.goal_sources` as strategy objects —
sim benchmarks replay vendored trajectory folders, robot benchmarks define
goals interactively — so this class only wires a source into the rollout
lifecycle and reports ``env.eval()`` stats after each episode.
"""

from visual_foresight_torch.agent.goal_sources import (
    InteractiveRobotGoalSource, TrajectoryFolderGoalSource)

from .general_agent import GeneralAgent


def _configured_ncam(hyperparams):
    """Camera count as the benchmark config declares it: robot configs list
    ``camera_topics``, sim configs may override ``ncam``, otherwise the env
    class default applies."""
    env_cls, env_params = hyperparams['env']
    if 'camera_topics' in env_params:
        return len(env_params['camera_topics'])
    if 'ncam' in env_params:
        return env_params['ncam']
    return env_cls.default_ncam()


class BenchmarkAgent(GeneralAgent):
    def __init__(self, hyperparams, start_saver=True):
        self.ncam = _configured_ncam(hyperparams)
        self._goal_source = None
        GeneralAgent.__init__(self, hyperparams, start_saver=start_saver)
        if not self._is_robot:
            # every episode re-creates a stored scene, so the xml must be
            # regenerated per trajectory
            self._hyperparams['gen_xml'] = 1

    # ---- goal-source wiring ------------------------------------------------

    def _source(self):
        if self._goal_source is None:
            if self._is_robot:
                self._goal_source = InteractiveRobotGoalSource(
                    self._hyperparams, self.ncam)
            else:
                self._goal_source = TrajectoryFolderGoalSource(
                    self._hyperparams, self.ncam)
        return self._goal_source

    def _apply_goal_spec(self, spec):
        self._reset_state = spec.reset_state
        if spec.goal_image is not None:
            self._goal_image = spec.goal_image
        if spec.goal_obj_pose is not None:
            self._goal_obj_pose = spec.goal_obj_pose
        if self._save_worker is not None and spec.save_path is not None:
            self._save_worker.put(('path', spec.save_path))

    # ---- GeneralAgent lifecycle hooks --------------------------------------

    def _setup_world(self, itr):
        if not self._is_robot:
            # the reset state must exist BEFORE the env is constructed
            self._apply_goal_spec(self._source().load(itr))
        GeneralAgent._setup_world(self, itr)
        declared = _configured_ncam(self._hyperparams)
        assert declared == self.ncam, \
            'environment has {} cameras but benchmark has {}'.format(
                self.ncam, declared)

    def _init(self):
        if self._is_robot:
            self._apply_goal_spec(self._source().define(self.env))
        else:
            self.env.set_goal_obj_pose(self._goal_obj_pose)
        return GeneralAgent._init(self)

    def _post_process_obs(self, env_obs, agent_data, initial_obs=False):
        obs = super()._post_process_obs(env_obs, agent_data, initial_obs)
        agent_data['verbose_worker'] = self._save_worker
        return obs

    def _required_rollout_metadata(self, agent_data, traj_ok, t, i_traj, i_itr,
                                   reset_state):
        GeneralAgent._required_rollout_metadata(self, agent_data, traj_ok, t,
                                                i_traj, i_itr, reset_state)
        if 'no_goal_def' not in self._hyperparams:
            agent_data['stats'] = self.env.eval(
                self._hyperparams.get('point_space_width',
                                      self._hyperparams['image_width']),
                self._hyperparams.get('_bench_save', None),
                self._hyperparams.get('ntask', 1))

        if not traj_ok and self._is_robot:
            # give the operator the chance to keep a failed hardware rollout
            print('WARNING: TRAJ FAILED')
            if 'n' in input('would you like to retry? (y/n): '):
                agent_data['traj_ok'] = True

    @property
    def record_path(self):
        if self._is_robot:
            return self._hyperparams['_bench_save']
        return self._hyperparams['data_save_dir'] + '/record/'
