"""Data-collection / benchmark CLI.

CLI contract identical to the reference's ``visual_mpc/sim/run.py``::

    python -m visual_foresight_torch.sim.run <hparams.py> \
        [--nworkers N] [--benchmark] [--nsplit K --isplit I] [--iex N]
        [--cloud] [--gpu_id G] [--ngpu NG]

The hparams file is executable Python exporting a module-level ``config``
dict.  The trajectory index range is split over worker processes; one
dedicated saver process drains the TFRecord queue.  Without ``--benchmark``
it collects data: each worker's ``Sim`` runs the config's agent and policy
(a random or scripted collection policy on the host, or a planning
controller) and hands every trajectory to the record saver or, with
``save_raw_images``, writes its raw folder.  The output root follows the
reference's conventions (``resolve_result_dir``: ``RESULT_DIR`` >
``EXPERIMENT_DIR`` > ``--cloud`` > the config's ``current_dir`` +
``/verbose``); with ``master_datadir`` in the agent's config a background
thread copies the data to it while the run lasts
(``util/synchronize_tfrecs.py``).

A policy that plans with a network (any CEM or inverse model controller)
runs on the card: on ``cuda:<gpu_id>`` (``--gpu_id`` plus the worker's
number), or on the CPU where the config's policy sets ``'device': 'cpu'``.
Without a card and without that key the runner refuses before it builds
anything; random and scripted policies stay on the host, a benchmark's
random baseline too.  Workers (``--nworkers`` > 1) are started with ``spawn``: a forked
child of a process that holds a CUDA context cannot use the card.
"""

import argparse
import copy
import datetime
import glob
import importlib.machinery
import importlib.util
import os
import random
import multiprocessing
import shutil
from multiprocessing import Manager, Process

import numpy as np

from visual_foresight_torch.agent.utils.traj_saver import record_worker
from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.policy.cem_controllers.cem_base_controller import (
    CEMBaseController)
from visual_foresight_torch.policy.inverse_models.inverse_model_base_controller import (  # noqa: E501
    InvModelBaseController)
from visual_foresight_torch.sim.benchmarks import perform_benchmark
from visual_foresight_torch.sim.simulator import Sim
from visual_foresight_torch.sim.util.combine_score import combine_scores
from visual_foresight_torch.sim.util.synchronize_tfrecs import (
    start_sync_thread)
from visual_foresight_torch.utils.sync import ManagedSyncCounter


def load_config(hyperparams_file):
    """Execute an hparams.py and return its ``config`` dict."""
    loader = importlib.machinery.SourceFileLoader('mod_hyper',
                                                  hyperparams_file)
    spec = importlib.util.spec_from_loader(loader.name, loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod.config


def build_argparser():
    p = argparse.ArgumentParser(description='run simulation experiments')
    p.add_argument('experiment', type=str, help='path to hparams.py')
    p.add_argument('--nworkers', type=int, default=1)
    p.add_argument('--gpu_id', type=int, default=0,
                   help='CUDA card of the first worker (worker i: gpu_id + i)')
    p.add_argument('--ngpu', type=int, default=1)
    p.add_argument('--nsplit', type=int, default=-1,
                   help='total number of machine-level splits')
    p.add_argument('--isplit', type=int, default=-1,
                   help='which split this invocation handles')
    p.add_argument('--cloud', action='store_true', default=False)
    p.add_argument('--benchmark', dest='do_benchmark', action='store_true',
                   default=False)
    p.add_argument('--iex', type=int, default=-1,
                   help='if != -1 only run this example')
    return p


def use_worker(conf, iex=-1, ngpu=1):
    """Entry point of one worker process."""
    print('started process with PID:', os.getpid())
    print('making trajectories {0} to {1}'.format(conf['start_index'],
                                                  conf['end_index']))
    # decorrelate the workers' host draws
    random.seed(None)
    np.random.seed(None)
    if conf.get('_do_benchmark', False):
        perform_benchmark(conf, iex, gpu_id=conf['gpu_id'])
    else:
        Sim(conf, gpu_id=conf['gpu_id'], ngpu=ngpu).run()


def check_and_pop(dict_, key):
    if dict_.pop(key, None) is not None:
        print('popping key: {}'.format(key))


def plans_on_device(policy_type):
    """Whether a policy of this class plans with a network: every CEM and
    inverse-model controller does, the random and scripted collection
    policies do not."""
    return isinstance(policy_type, type) and issubclass(
        policy_type, (CEMBaseController, InvModelBaseController))


def apply_machine_split(hyperparams, nsplit, isplit):
    """Narrow [start_index, end_index] to this machine's shard (--nsplit)."""
    if nsplit == -1:
        return
    assert 0 <= isplit < nsplit, 'isplit must be in [0, nsplit-1]'
    lo, hi = hyperparams['start_index'], hyperparams['end_index']
    per_split = max((hi + 1 - lo) / nsplit, 1)
    hyperparams['start_index'] = int(lo + isplit * per_split)
    hyperparams['end_index'] = int(lo + (isplit + 1) * per_split - 1)


def worker_index_ranges(start, end, n_worker):
    """Contiguous per-worker [start, end] index ranges."""
    n_traj = end - start + 1
    per_worker = int(n_traj // np.float32(n_worker))
    return [(start + per_worker * i, start + per_worker * (i + 1) - 1)
            for i in range(n_worker)]


def clean_autogen_scenes(agent_params):
    """Drop stale auto-generated MuJoCo scene XMLs from earlier runs."""
    scene_dir = os.path.dirname(agent_params.get('filename', ''))
    for stale in glob.glob(os.path.join(scene_dir, 'auto_gen', '*')):
        try:
            os.remove(stale)
        except OSError:
            pass


def _exp_name(hyperparams):
    """Experiment name for RESULT_DIR layouts, derived the same way the
    reference does: explicit > data_save_dir path tail > record path tail."""
    if 'exp_name' in hyperparams:
        return hyperparams['exp_name']
    agent = hyperparams['agent']
    if 'data_save_dir' in agent:
        parts = agent['data_save_dir'].split('/')
        anchors = [i for i, p in enumerate(parts) if p == 'experiments']
        first = min(max(anchors + [0]) + 1, len(parts) - 1)
        return '/'.join(parts[first:])
    if 'record' in agent:
        tail = [p for p in agent['record'].split('/')
                if p and p != 'record']
        return tail[-1]
    raise NotImplementedError("can't find exp name")


def resolve_result_dir(args, hyperparams, hyperparams_file):
    """Pick the output root according to the env-var conventions the
    reference supports (RESULT_DIR > EXPERIMENT_DIR > --cloud > verbose/)."""
    if 'RESULT_DIR' in os.environ:
        now = datetime.datetime.now()
        mode = 'experiments' if args.do_benchmark else 'traj_data'
        result_dir = '{}/{}/{}/exp_{}_{}_{}_{}_{}'.format(
            os.environ['RESULT_DIR'], mode, _exp_name(hyperparams),
            now.year, now.month, now.day, now.hour, now.minute)
        os.makedirs(result_dir)
        shutil.copyfile(hyperparams_file,
                        os.path.join(result_dir, 'hparams.py'))
        if 'verbose' in hyperparams['policy']:
            os.makedirs(os.path.join(result_dir, 'verbose'), exist_ok=True)
        if 'data_save_dir' in hyperparams['agent']:
            hyperparams['agent']['data_save_dir'] = result_dir
        return result_dir
    if 'EXPERIMENT_DIR' in os.environ:
        subpath = hyperparams['current_dir'].partition('experiments')[2]
        return os.path.join(os.environ['EXPERIMENT_DIR'] + subpath)
    if args.cloud:
        check_and_pop(hyperparams, 'save_raw_images')
        check_and_pop(hyperparams['agent'], 'make_final_gif')
        check_and_pop(hyperparams['agent'], 'make_final_gif_pointoverlay')
        hyperparams['agent']['data_save_dir'] = '/result/'
        return None
    return hyperparams['current_dir'] + '/verbose'


def prepare_saver(hyperparams):
    """Shared record queue + counter; spawn the TFRecord saver process when
    record saving is active."""
    m = Manager()
    record_queue, counter = m.Queue(), ManagedSyncCounter(m)
    saver_proc = None
    if hyperparams.get('save_data', True) and \
            not hyperparams.get('save_raw_images', False):
        saver_proc = Process(
            target=record_worker,
            args=(record_queue,
                  hyperparams['agent']['data_save_dir'] + '/records',
                  hyperparams['agent']['T'],
                  hyperparams.get('seperate_good', False),
                  hyperparams.get('traj_per_file', 16),
                  hyperparams['start_index'],
                  (0.90, 0.05, 0.05),
                  hyperparams.get('image_coding', 'raw')))
        saver_proc.start()
    return record_queue, saver_proc, counter


def build_worker_configs(hyperparams, args, ranges, result_dir, record_queue,
                         counter):
    confs = []
    for i, (lo, hi) in enumerate(ranges):
        conf = copy.deepcopy(hyperparams)
        conf['start_index'], conf['end_index'] = lo, hi
        conf['ntraj'] = hyperparams['end_index'] - \
            hyperparams['start_index'] + 1
        # counter-based indices are 0-based across the whole run, while each
        # worker's start_index is its private range lo; keep the run-global
        # base around so workers can report absolute trajectory ids
        conf['_global_start_index'] = hyperparams['start_index']
        conf['gpu_id'] = i + args.gpu_id
        conf['result_dir'] = result_dir
        conf['_do_benchmark'] = args.do_benchmark
        if record_queue is not None:
            conf['record_saver'] = record_queue
            conf['counter'] = counter
        confs.append(conf)
    return confs


def main(cmd_args=None):
    args = build_argparser().parse_args(cmd_args)
    assert os.path.isfile(args.experiment), 'hyperparams file does not exist!'

    parallel = args.nworkers > 1
    print('parallel ', parallel)

    hyperparams = load_config(args.experiment)
    if plans_on_device(hyperparams['policy']['type']):
        # no quiet fallback to the CPU: the planning policy needs the card
        # unless its config says 'cpu'; checked before anything is built.
        # A random baseline plans nothing, with or without --benchmark
        resolve_device(hyperparams['policy'].get('device', 'cuda'))
    apply_machine_split(hyperparams, args.nsplit, args.isplit)
    ranges = worker_index_ranges(hyperparams['start_index'],
                                 hyperparams['end_index'], args.nworkers)

    if 'gen_xml' in hyperparams['agent']:
        clean_autogen_scenes(hyperparams['agent'])

    result_dir = resolve_result_dir(args, hyperparams, args.experiment)
    if result_dir is not None:
        os.makedirs(result_dir, exist_ok=True)

    sync = None
    if 'master_datadir' in hyperparams['agent']:
        sync = start_sync_thread(hyperparams['agent'])
        print('launched sync thread')

    record_queue, saver_proc, counter = None, None, None
    if 'data_save_dir' in hyperparams['agent']:
        record_queue, saver_proc, counter = prepare_saver(hyperparams)

    if args.iex != -1:
        hyperparams['agent']['iex'] = args.iex

    confs = build_worker_configs(hyperparams, args, ranges, result_dir,
                                 record_queue, counter)
    if parallel:
        # plain (non-daemonic) processes: workers must be able to fork their
        # own file-saver children, which Pool's daemonic workers cannot
        ctx = multiprocessing.get_context('spawn')
        procs = [ctx.Process(target=use_worker, args=(c,)) for c in confs]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    else:
        use_worker(confs[0], args.iex, args.ngpu)

    if record_queue is not None and \
            not hyperparams.get('save_raw_images', False):
        record_queue.put(None)  # saver drains its queue, then exits
        if saver_proc is not None:
            saver_proc.join()

    if sync is not None:
        sync.stop()

    if args.do_benchmark:
        combine_scores(hyperparams, result_dir)
    return result_dir


if __name__ == '__main__':
    main()
