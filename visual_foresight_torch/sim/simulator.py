"""Per-worker collection loop.

One ``Sim`` owns one agent + one policy (built from the experiment config
dict) and iterates trajectory indices — either a fixed ``[start, end]`` range
or a shared cross-worker counter — handing each finished trajectory to the
raw-image saver or the TFRecord queue.  Capability parity with the
reference's ``visual_mpc/sim/simulator.py``.
"""

import os

from visual_foresight_torch.agent.utils.raw_saver import RawSaver


class Sim(object):
    """Runs one worker's share of an experiment."""

    def __init__(self, config, gpu_id=0, ngpu=1, logger=None,
                 task_mode='train'):
        self._hyperparams = config
        self.task_mode = task_mode

        self.agentparams = config['agent']
        self.agentparams['gpu_id'] = gpu_id
        self.agent = self.agentparams['type'](self.agentparams)

        self.policyparams = config['policy']
        self.policy = self.policyparams['type'](
            self.agent._hyperparams, self.policyparams, gpu_id, ngpu)

        # cross-process plumbing is injected by the runner and must not leak
        # into saved configs, hence pop
        self._record_queue = config.pop('record_saver', None)
        self._counter = config.pop('counter', None)

    def _index_stream(self):
        """Trajectory indices this worker should run: a private contiguous
        range, or pulls from the shared counter until ``ntraj`` is hit."""
        if self._counter is None:
            lo = self._hyperparams['start_index']
            hi = self._hyperparams['end_index']
            yield from range(lo, hi + 1)
            return
        total = self._hyperparams['ntraj']
        # counter indices are 0-based within this run; shard names are offset
        # by the campaign-global start index, so print the absolute
        # trajectory id too — the campaign restart driver resumes from it
        base = self._hyperparams.get('_global_start_index',
                                     self._hyperparams.get('start_index', 0))
        while True:
            itr = self._counter.ret_increment
            if itr >= total:
                return
            print('taking sample {} of {} (traj {})'.format(
                itr, total, base + itr))
            yield itr

    def run(self):
        """Iterate the index stream; optionally survive unproducible indices.

        With ``skip_bad_trajs: True`` in the config, a ``Bad_Traj_Exception``
        (every retry of one trajectory failed — e.g. a transiently broken
        scene) skips that index after forcing a full world rebuild, instead
        of aborting a multi-hour collection campaign.  A cap of 5
        *consecutive* skipped indices still aborts, so a permanently broken
        worker cannot spin at imax rollouts per index forever."""
        from visual_foresight_torch.agent.general_agent import Bad_Traj_Exception
        skip_bad = self._hyperparams.get('skip_bad_trajs', False)
        consecutive_bad = 0
        for itr in self._index_stream():
            try:
                self.take_sample(itr)
                consecutive_bad = 0
            except Bad_Traj_Exception as exc:
                if not skip_bad:
                    raise
                consecutive_bad += 1
                print('skipping unproducible traj {} ({} consecutive): {}'
                      .format(itr, consecutive_bad, exc))
                if consecutive_bad >= 5:
                    raise
                self.agent._setup_world(itr)   # rebuild scene + renderer
        self.agent.cleanup()

    def take_sample(self, sample_index):
        self.policy.reset()
        agent_data, obs_dict, policy_out = \
            self.agent.sample(self.policy, sample_index)
        if self._hyperparams.get('save_data', True):
            self.save_data(sample_index, agent_data, obs_dict, policy_out)
        return agent_data

    def save_data(self, itr, agent_data, obs_dict, policy_outputs):
        if self._hyperparams.get('save_only_good', False) and \
                not agent_data['goal_reached']:
            return
        if self._hyperparams.get('save_raw_images', False):
            self._save_raw_data(itr, agent_data, obs_dict, policy_outputs)
        elif self._record_queue is not None:
            self._record_queue.put((agent_data, obs_dict, policy_outputs))
        else:
            raise ValueError('Saving neither raw data nor records')

    def _save_raw_data(self, itr, agent_data, obs_dict, policy_outputs):
        # layout: <data_save_dir>/<task_mode>/traj_group{N}/traj{i}
        saver = RawSaver(
            os.path.join(self.agentparams['data_save_dir'], self.task_mode),
            self._hyperparams.get('ngroup', 1000), subdir='')
        saver.save_traj(itr, agent_data, obs_dict, policy_outputs)
