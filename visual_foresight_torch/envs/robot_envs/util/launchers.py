"""Robot-stack process launchers.

Capabilities of the reference's launch files, as plain supervised Python
processes instead of roslaunch XML / bash loops:

* ``start_gripper`` — keeps the WSG-50 TCP driver node alive
  (reference ``foresight_rospkg/launch/start_gripper.launch``: the
  ``wsg_50_driver/wsg_50_ip`` node with ip/port/rate params).
* ``start_impedance`` — keeps the arm enabled with the soft interaction
  (impedance) options active (reference
  ``foresight_rospkg/launch/start_impedance.sh``: an enable +
  set_interaction_options retry loop).

CLI::

    python -m visual_foresight_torch.envs.robot_envs.util.launchers \
        start_gripper [--ip ... --port ... --rate ...]
    python -m visual_foresight_torch.envs.robot_envs.util.launchers \
        start_impedance [--stiffness 0.05 0.05 1600 10 10 10]

The port's copy of
``visual_foresight_tpu/envs/robot_envs/util/launchers.py``.
"""

import argparse
import subprocess
import sys
import time


def supervise(cmd_factory, retry_delay=2.0, name='process'):
    """Run the command in a loop, restarting on exit (the reference's
    ``while true`` supervision), until KeyboardInterrupt."""
    while True:
        proc = None
        try:
            proc = cmd_factory()
            rc = proc.wait()
            print('{} exited rc={}; restarting in {:.0f}s'.format(
                name, rc, retry_delay))
        except KeyboardInterrupt:
            if proc is not None:
                proc.terminate()
            return
        time.sleep(retry_delay)


def start_gripper(args):
    cmd = ['rosrun', 'wsg_50_driver', 'wsg_50_ip',
           '_ip:={}'.format(args.ip), '_port:={}'.format(args.port),
           '_rate:={}'.format(args.rate), '_com_mode:=auto_update']
    print('launching WSG-50 driver:', ' '.join(cmd))
    supervise(lambda: subprocess.Popen(cmd), name='wsg_50_driver')


def start_impedance(args):
    """Enable the robot and (re-)assert soft interaction options forever —
    after an e-stop or collision trip the arm comes back enabled in
    impedance mode without operator action."""
    k = [str(v) for v in args.stiffness]

    def one_round():
        subprocess.run(['rosrun', 'intera_interface', 'enable_robot.py', '-e'],
                       check=False)
        return subprocess.Popen(
            ['rosrun', 'intera_examples', 'set_interaction_options.py',
             '-r', str(args.rate), '-k'] + k
            + ['-m'] + [str(m) for m in args.mode])

    supervise(one_round, retry_delay=args.retry_delay, name='impedance mode')


def main(cmd_args=None):
    parser = argparse.ArgumentParser(description='robot stack launchers')
    sub = parser.add_subparsers(dest='cmd', required=True)

    g = sub.add_parser('start_gripper')
    g.add_argument('--ip', type=str, default='128.32.156.182')
    g.add_argument('--port', type=int, default=1000)
    g.add_argument('--rate', type=float, default=1.0)
    g.set_defaults(fn=start_gripper)

    i = sub.add_parser('start_impedance')
    i.add_argument('--rate', type=int, default=10)
    i.add_argument('--stiffness', type=float, nargs=6,
                   default=[0.05, 0.05, 1600, 10, 10, 10])
    i.add_argument('--mode', type=int, nargs=6, default=[1, 1, 0, 1, 1, 1])
    i.add_argument('--retry_delay', type=float, default=2.0)
    i.set_defaults(fn=start_impedance)

    args = parser.parse_args(cmd_args)
    args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
