"""Benchmark driver: per-trajectory goal-conditioned evaluation with incremental
score reports (reference ``visual_mpc/sim/benchmarks.py``).  At the end the
agent's file worker is drained and stopped, so the plan dumps are on disk
when ``perform_benchmark`` returns."""

import os
import pickle
from collections import OrderedDict

import numpy as np

from .simulator import Sim
from .util.combine_score import write_scores


def perform_benchmark(conf=None, iex=-1, gpu_id=None, ngpu=1):
    """Run benchmark trajectories [start_index, end_index] (or just ``iex``),
    accumulating the env's eval stats and writing pkl + txt reports after every
    trajectory so partial runs still report."""
    result_dir = conf['result_dir']

    print('-' * 67)
    print('agent settings')
    for key, val in conf['agent'].items():
        print(key, ': ', val)
    print('-' * 24)
    print('policy settings')
    for key, val in conf['policy'].items():
        print(key, ': ', val)
    print('-' * 67)

    sim = Sim(conf, gpu_id=gpu_id if gpu_id is not None else 0, ngpu=ngpu,
              task_mode='bench')

    if iex == -1:
        i_traj = conf['start_index']
        nruns = conf['end_index']
        print('started worker going from ind {} to ind {}'.format(i_traj, nruns))
    else:
        i_traj = iex
        nruns = iex

    stats_lists = OrderedDict()

    if 'sourcetags' in conf and 'VMPC_DATA_DIR' in os.environ:
        datapath = conf['source_basedirs'][0].partition('pushing_data')[2]
        conf['source_basedirs'] = [os.environ['VMPC_DATA_DIR'] + datapath]

    result_file = result_dir + '/results_{}to{}.txt'.format(
        conf['start_index'], conf['end_index'])
    final_dist_pkl_file = result_dir + '/scores_{}to{}.pkl'.format(
        conf['start_index'], conf['end_index'])

    try:
        while i_traj <= nruns:
            print('-' * 67)
            print('run number ', i_traj)
            print('-' * 67)

            record_dir = result_dir + '/verbose/traj{0}'.format(i_traj)
            os.makedirs(record_dir, exist_ok=True)
            sim.agent._hyperparams['record'] = record_dir

            # skip_bad_trajs (config-gated, same contract as Simulator.run): a
            # task whose every retry fails — e.g. a policy that leaves a
            # replayed scene in a state the validity check rejects — drops out
            # of the campaign (logged) instead of aborting the remaining tasks;
            # the aggregates then cover the tasks that ran.
            if conf.get('skip_bad_trajs', False):
                from visual_foresight_torch.agent.general_agent import (
                    Bad_Traj_Exception)
                try:
                    agent_data = sim.take_sample(i_traj)
                except Bad_Traj_Exception as exc:
                    print('benchmark task {} skipped: {!r}'.format(i_traj, exc))
                    i_traj += 1
                    continue
            else:
                agent_data = sim.take_sample(i_traj)

            stats_data = agent_data['stats']
            stat_arrays = OrderedDict()
            for key in stats_data:
                stats_lists.setdefault(key, []).append(stats_data[key])
                stat_arrays[key] = np.array(stats_lists[key])

            i_traj += 1

            with open(final_dist_pkl_file, 'wb') as f:
                pickle.dump(stat_arrays, f)
            write_scores(conf, result_file, stat_arrays, i_traj)
    finally:
        sim.agent.cleanup()
