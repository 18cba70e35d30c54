"""Robot environments and the controller registry.

The port's copy of ``visual_foresight_tpu/envs/robot_envs/__init__.py``
(reference ``robot_envs/__init__.py:5-22``).  ``get_controller_class``
returns a class given as ``robot_type`` as it is: tests and the card's smoke
run pass their kinematic fake arm this way.
"""


def get_controller_class(robot_type):
    if not isinstance(robot_type, str):
        return robot_type   # custom controller class (tests, new robots)
    if robot_type == 'sawyer':
        from .sawyer.sawyer_impedance import SawyerImpedanceController
        return SawyerImpedanceController
    if robot_type == 'widowx':
        from .widowx.widowx_controller import WidowXController
        return WidowXController
    if robot_type == 'franka':
        from .franka.franka_impedance import FrankaImpedanceController
        return FrankaImpedanceController
    if robot_type == 'baxter':
        from .baxter.baxter_impedance import BaxterImpedanceController
        return BaxterImpedanceController
    if robot_type == 'kuka':
        from .kuka.kuka_impedance import KukaImpedanceController
        return KukaImpedanceController
    raise NotImplementedError('unknown robot type {}'.format(robot_type))
