"""Interactive end-effector pose readout for calibration.

Capability of reference ``foresight_rospkg/src/utils/get_points.py``: bring
up the robot's impedance controller and print XYZ + euler angles either on
the robot's wheel/navigator button (when the vendor SDK is present) or on
Enter at the console — used when measuring workspace bounds and camera
calibration points.

CLI::

    python -m visual_foresight_torch.envs.robot_envs.util.get_points \
        [--robot sawyer|baxter|franka|kuka] [--limb right]

The port's copy of
``visual_foresight_tpu/envs/robot_envs/util/get_points.py``.
"""

import argparse
import logging

import numpy as np


def make_controller(robot, limb):
    if robot == 'sawyer':
        from ..sawyer.sawyer_impedance import SawyerImpedanceController
        return SawyerImpedanceController('sawyer', True,
                                         gripper_attached='none')
    if robot == 'baxter':
        from ..baxter.baxter_impedance import BaxterImpedanceController
        return BaxterImpedanceController('baxter', True,
                                         gripper_attached='none', limb=limb)
    if robot == 'franka':
        from ..franka.franka_impedance import FrankaImpedanceController
        return FrankaImpedanceController('franka', True,
                                         gripper_attached='hand')
    if robot == 'kuka':
        from ..kuka.kuka_impedance import KukaImpedanceController
        return KukaImpedanceController('kuka', True, gripper_attached='none')
    raise NotImplementedError('unknown robot {}'.format(robot))


def print_pose(controller):
    xyz, quat = controller.get_xyz_quat()
    yaw, roll, pitch = [np.rad2deg(a) for a in controller.quat_2_euler(quat)]
    msg = 'XYZ IS: {}, ROTATION IS: yaw={} roll={} pitch={}'.format(
        xyz, yaw, roll, pitch)
    logging.getLogger('robot_logger').info(msg)
    print(msg)


def _register_button(robot, limb, callback):
    """Hook the vendor navigator button when available; returns True when a
    button hook was installed (else the caller falls back to the console)."""
    try:
        if robot == 'sawyer':
            import intera_interface
            nav = intera_interface.Navigator()
            nav.register_callback(lambda v: v and callback(),
                                  'right_button_show')
            return True
        if robot == 'baxter':
            import baxter_interface
            nav = baxter_interface.Navigator(limb)
            nav.button0_changed.connect(lambda v: v and callback())
            return True
    except ImportError:
        pass
    return False


def main(cmd_args=None):
    parser = argparse.ArgumentParser(
        description='prints robot end-effector points')
    parser.add_argument('--robot', type=str, default='sawyer')
    parser.add_argument('--limb', type=str, default='right')
    args = parser.parse_args(cmd_args)

    controller = make_controller(args.robot, args.limb)
    print_pose(controller)

    if _register_button(args.robot, args.limb, lambda: print_pose(controller)):
        print('press the navigator button to print the current pose; Ctrl-C to quit')
        import rospy
        rospy.spin()
    else:
        print('no navigator SDK; press Enter to print the pose, Ctrl-D to quit')
        try:
            while True:
                input()
                print_pose(controller)
        except (EOFError, KeyboardInterrupt):
            pass


if __name__ == '__main__':
    main()
