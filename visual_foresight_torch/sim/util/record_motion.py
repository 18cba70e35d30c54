"""Record a pushback (object-redistribution) trajectory
(reference ``foresight_rospkg/src/utils/record_motion.py``).

Put the arm into gravity-compensation / zero-G mode, move it through the sweep
by hand, and this tool samples joint angles at a fixed rate into the pkl the
impedance controllers replay in ``redistribute_objects``.

CLI::

    python -m visual_foresight_torch.sim.util.record_motion <robot_type> \
        <robot_name> [--rate HZ --duration S --out pushback_traj_<name>.pkl]

The port's copy of ``visual_foresight_tpu/sim/util/record_motion.py``.
"""

import argparse
import os
import pickle as pkl
import time


def record(controller, rate_hz, duration_s):
    joints = []
    period = 1.0 / rate_hz
    t_end = time.time() + duration_s
    print('recording for {:.0f}s at {} Hz — move the arm now'.format(
        duration_s, rate_hz))
    while time.time() < t_end:
        joints.append(controller.get_joint_angles())
        time.sleep(period)
    return joints


def main(cmd_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('robot_type', type=str)
    parser.add_argument('robot_name', type=str)
    parser.add_argument('--rate', type=float, default=100.0)
    parser.add_argument('--duration', type=float, default=20.0)
    parser.add_argument('--out', type=str, default='')
    args = parser.parse_args(cmd_args)

    from visual_foresight_torch.envs.robot_envs import get_controller_class
    controller = get_controller_class(args.robot_type)(
        args.robot_name, gripper_attached='none')

    input('press enter to start recording (enable zero-G mode first)...')
    joints = record(controller, args.rate, args.duration)

    out = args.out or 'pushback_traj_{}.pkl'.format(args.robot_name)
    os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
    with open(out, 'wb') as f:
        pkl.dump(joints, f)
    print('saved {} samples to {}'.format(len(joints), out))


if __name__ == '__main__':
    main()
