"""Robot experiment CLI (reference ``foresight_rospkg/src/run_robot.py``).

Per-robot config overrides (``override_<robot>`` blocks), RESULT_DIR
redirects, benchmark-name prompts, checkpoint.pkl resume, and raw jpeg+pkl
saving with env metadata.

Usage::

    python -m visual_foresight_torch.sim.run_robot <hparams.py> <robot_name> \
        [--benchmark] [-r to resume]

The port's copy of ``visual_foresight_tpu/sim/run_robot.py``.  A policy
that plans with a network (any CEM or inverse-model controller) runs on the
card, or on the CPU where the config's policy sets ``'device': 'cpu'``:
without a card and without that key ``RobotEnvironment`` refuses before it
builds the agent or the policy, as ``sim/run.py`` does.  ``agent_data.pkl``
leaves out the benchmark agent's file worker (``verbose_worker``).
"""

import argparse
import datetime
import json
import os
import pickle as pkl
import shutil

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.sim.run import load_config, plans_on_device


class RobotEnvironment:
    def __init__(self, config, resume=False, benchmark=False):
        self._hyperparams = config
        self.agentparams, self.policyparams = config['agent'], config['policy']
        self._benchmark = benchmark

        if plans_on_device(self.policyparams['type']):
            # no quiet fallback to the CPU, checked before anything is built
            resolve_device(self.policyparams.get('device', 'cuda'))
        if 'imax' not in self.agentparams:
            self.agentparams['imax'] = 5

        self.agent = self.agentparams['type'](self.agentparams)
        self.policy = self.policyparams['type'](
            self.agent._hyperparams, self.policyparams, 0, 1)

        self._ck_path = os.path.join(
            self.agentparams['data_save_dir'], 'checkpoint.pkl')
        self._start_itr = 0
        if resume and os.path.isfile(self._ck_path):
            with open(self._ck_path, 'rb') as f:
                self._start_itr = pkl.load(f)['ntraj']
            print('resuming at traj {}'.format(self._start_itr))

    def run(self):
        n_traj = self._hyperparams['end_index'] + 1
        for itr in range(self._start_itr, n_traj):
            self.take_sample(itr)

    def take_sample(self, itr):
        print('-' * 60)
        print('trajectory {}'.format(itr))
        if self._benchmark:
            bench_dir = os.path.join(
                self.agentparams['data_save_dir'], 'bench',
                'traj{}'.format(itr))
            self.agent._hyperparams['_bench_save'] = bench_dir
        self.policy.reset()
        agent_data, obs_dict, policy_out = self.agent.sample(self.policy, itr)
        self._save_raw_images(itr, agent_data, obs_dict, policy_out)
        with open(self._ck_path, 'wb') as f:
            pkl.dump({'ntraj': itr + 1,
                      'timestamp': datetime.datetime.now().isoformat()}, f)

    def _save_raw_images(self, itr, agent_data, obs_dict, policy_out):
        ngroup = self._hyperparams.get('ngroup', 1000)
        igrp = itr // ngroup
        group_folder = os.path.join(self.agentparams['data_save_dir'],
                                    'raw', 'traj_group{}'.format(igrp))
        os.makedirs(group_folder, exist_ok=True)
        traj_folder = os.path.join(group_folder, 'traj{}'.format(itr))
        if os.path.exists(traj_folder):
            shutil.rmtree(traj_folder)
        os.makedirs(traj_folder)

        images = obs_dict.pop('images', None)
        if images is not None:
            import cv2
            T, ncam = images.shape[:2]
            for n in range(ncam):
                os.makedirs(os.path.join(traj_folder, 'images{}'.format(n)))
            for t in range(T):
                for n in range(ncam):
                    cv2.imwrite('{}/images{}/im_{}.jpg'.format(
                        traj_folder, n, t), images[t, n][:, :, ::-1])

        # the benchmark agent's file worker is a live handle, not data: the
        # JAX package pickles its queue proxy, which no later process can
        # load once the run's manager is gone
        agent_data = {k: v for k, v in agent_data.items()
                      if k != 'verbose_worker'}
        for name, data in (('agent_data', agent_data),
                           ('obs_dict', obs_dict),
                           ('policy_out', policy_out)):
            with open('{}/{}.pkl'.format(traj_folder, name), 'wb') as f:
                pkl.dump(data, f)

        meta = {'robot': self._hyperparams['agent']['env'][1].get(
                    'robot_name', 'unknown'),
                'time': datetime.datetime.now().isoformat()}
        with open('{}/env_metadata.json'.format(traj_folder), 'w') as f:
            json.dump(meta, f)


def main(cmd_args=None):
    parser = argparse.ArgumentParser(description='run robot experiments')
    parser.add_argument('experiment', type=str)
    parser.add_argument('robot_name', type=str)
    parser.add_argument('--benchmark', action='store_true', default=False)
    parser.add_argument('-r', '--resume', action='store_true', default=False)
    args = parser.parse_args(cmd_args)

    config = load_config(args.experiment)
    config['agent']['env'][1]['robot_name'] = args.robot_name

    # per-robot overrides: hparams may define override_<robot_name> dicts
    override = config.pop('override_{}'.format(args.robot_name), None)
    if override:
        for block in ('agent', 'policy'):
            for k, v in override.get(block, {}).items():
                config[block][k] = v

    if 'RESULT_DIR' in os.environ:
        config['agent']['data_save_dir'] = os.environ['RESULT_DIR']

    if args.benchmark:
        name = input('benchmark name: ').strip()
        config['agent']['data_save_dir'] = os.path.join(
            config['agent']['data_save_dir'], 'bench_' + name)
    os.makedirs(config['agent']['data_save_dir'], exist_ok=True)

    RobotEnvironment(config, resume=args.resume,
                     benchmark=args.benchmark).run()


if __name__ == '__main__':
    main()
