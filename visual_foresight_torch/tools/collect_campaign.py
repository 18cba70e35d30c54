"""Restarting runner of a long collection campaign, on the port: the twin of
``scripts/collect_campaign.sh``.

A long unattended MuJoCo collection can die on a transient fault (a lost
EGL context, a scene that the retry budget cannot rescue).  This runner
runs ``python -m visual_foresight_torch.sim.run <hparams.py>`` with
``VMPC_START_INDEX`` and ``VMPC_END_INDEX`` set, its output appended to the
log, and where the worker dies restarts it after the last trajectory the
log names: the simulator prints each trajectory's absolute index as
``(traj N)`` (the bare ``taking sample N`` count starts at 0 in every run
and would be wrong once ``VMPC_START_INDEX`` is not 0).  Shard names are
index ranges (``traj_X_to_Y``), so a restart overwrites at most one
partly written shard.  It gives up after ``MAX_RESTARTS`` restarts (exit
1) and stops once the next index passes ``end_index``.
``VMPC_DATA_DIR`` and ``VMPC_START_INDEX`` are read from the environment.
Host only: collection draws and renders on the host.

Usage::

    python -m visual_foresight_torch.tools.collect_campaign \\
        <hparams.py> <end_index> <logfile>
"""

import argparse
import os
import re
import subprocess
import sys

MAX_RESTARTS = 50
PYTHON = sys.executable
RUNNER = 'visual_foresight_torch.sim.run'


def last_traj(log):
    """The last ``(traj N)`` that ``log`` names, or None."""
    with open(log, errors='replace') as f:
        found = re.findall(r'\(traj ([0-9]*)\)', f.read())
    digits = found[-1] if found else ''
    return int(digits) if digits else None


def note(log, line):
    with open(log, 'a') as f:
        f.write(line + '\n')


def run(conf, end, log):
    """Run the campaign to ``end``; returns the exit code (0, or 1 after
    ``MAX_RESTARTS`` restarts)."""
    start = int(os.environ.get('VMPC_START_INDEX', 0))
    restarts = 0
    while True:
        env = dict(os.environ, VMPC_START_INDEX=str(start),
                   VMPC_END_INDEX=str(end))
        with open(log, 'a') as out:
            rc = subprocess.call([PYTHON, '-m', RUNNER, conf], env=env,
                                 stdout=out, stderr=subprocess.STDOUT)
        if rc == 0:
            break
        last = last_traj(log)
        nxt = (start if last is None else last) + 1
        restarts += 1
        if restarts > MAX_RESTARTS:
            note(log, 'campaign: giving up after {} restarts (rc={})'.format(
                MAX_RESTARTS, rc))
            return 1
        if nxt > end:
            break
        note(log, 'campaign: worker died rc={}; restarting at index {} '
                  '(restart {})'.format(rc, nxt, restarts))
        start = nxt
    note(log, 'campaign: complete (end_index={}, restarts={})'.format(
        end, restarts))
    return 0


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('conf', help='the collection config (a campaign twin)')
    p.add_argument('end_index', type=int)
    p.add_argument('logfile')
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return run(args.conf, args.end_index, args.logfile)


if __name__ == '__main__':
    sys.exit(main())
