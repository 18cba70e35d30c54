"""Rebuild the flagship predictor from scratch on the port: the twin of the
``Makefile``'s ``bench_model`` recipe.

Three steps, each a command of the port (or of ``scripts/``, which serves
both packages):

1. collect 1100 random-policy xz-grasp trajectories with
   ``campaigns/collect_xz_r4.py`` through the restarting runner
   (``tools/collect_campaign.py``), skipped where the records are there;
2. merge the good and bad halves (``scripts/merge_record_splits.py``);
3. train the space-to-depth flagship with the port's trainer
   (``training/train_predictor.py``) on the recipe's flags, 5000 steps of
   batch 32 in bf16, a checkpoint every 1000 steps.

Paths are options with the ``Makefile``'s layout under ``--data_root``:
``<data_root>/collect/xz_r4/records`` and ``<data_root>/models/
xz_flagship``.  ``--data_root`` defaults to ``$DATA_ROOT`` (as ``make``
reads it) or else ``build/bench_model`` of this checkout.  Training runs on
the card; ``--device cpu`` asks for the CPU.  ``--dry_run`` prints the
commands and runs none.

Usage::

    python -m visual_foresight_torch.tools.bench_model [--data_root DIR]
        [--flagship DIR] [--records DIR] [--ntraj N] [--device cpu]
        [--dry_run]
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TWIN = os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                    'collect_xz_r4.py')
MERGE = os.path.join(REPO, 'scripts', 'merge_record_splits.py')
NTRAJ = 1100
# the recipe's trainer flags (Makefile, bench_model)
TRAIN_FLAGS = ['--steps', '5000', '--batch_size', '32', '--bf16',
               '--std_factor', '4', '--enc_features', '128', '256', '256',
               '--lstm_kernel', '3', '--ss_k', '300', '--ckpt_every', '1000']


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--data_root', default=os.environ.get(
        'DATA_ROOT', os.path.join(REPO, 'build', 'bench_model')))
    p.add_argument('--flagship', default=None,
                   help='the model directory (<data_root>/models/'
                        'xz_flagship)')
    p.add_argument('--records', default=None,
                   help='the records (<data_root>/collect/xz_r4/records)')
    p.add_argument('--ntraj', type=int, default=NTRAJ)
    p.add_argument('--device', default='cuda')
    p.add_argument('--dry_run', action='store_true')
    return p


def records_exist(records):
    train = os.path.join(records, 'good', 'train')
    return os.path.isdir(train) and bool(os.listdir(train))


def plan(args):
    """The recipe's steps: (what, environment updates, argv), collection
    left out where the records exist."""
    collect_dir = os.path.join(args.data_root, 'collect', 'xz_r4')
    records = args.records or os.path.join(collect_dir, 'records')
    flagship = args.flagship or os.path.join(args.data_root, 'models',
                                             'xz_flagship')
    steps = []
    if not records_exist(records):
        steps.append(('collect', {'VMPC_DATA_DIR': collect_dir}, [
            sys.executable, '-m',
            'visual_foresight_torch.tools.collect_campaign', TWIN,
            str(args.ntraj - 1),
            os.path.join(args.data_root, 'collect', 'xz_r4_collect.log')]))
    steps.append(('merge', {}, [sys.executable, MERGE, records]))
    steps.append(('train', {}, [
        sys.executable, '-m',
        'visual_foresight_torch.training.train_predictor',
        '--data_dir', os.path.join(records, 'all'), '--model_dir', flagship]
        + TRAIN_FLAGS + ['--device', args.device]))
    return steps


def main(argv=None):
    args = build_argparser().parse_args(argv)
    steps = plan(args)
    for what, env, argv in steps:
        print('{}: {}{}'.format(what, ''.join('{}={} '.format(k, v)
                                              for k, v in env.items()),
                                ' '.join(argv)))
        if args.dry_run:
            continue
        if what == 'collect':
            os.makedirs(env['VMPC_DATA_DIR'], exist_ok=True)
        rc = subprocess.call(argv, env=dict(os.environ, **env), cwd=REPO)
        if rc != 0:
            print('{} failed (exit {})'.format(what, rc))
            return rc
    return 0


if __name__ == '__main__':
    sys.exit(main())
