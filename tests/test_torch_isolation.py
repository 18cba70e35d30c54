"""The port stands alone: importing every module of ``visual_foresight_torch``
and ``chip_smoke`` pulls in neither JAX nor the JAX package (nor ``h5py``,
``cv2``, ``google_crc32c``, ``mujoco``, ``imageio`` or ``matplotlib``, which
the card machine may lack; every module imports with those and
``ml_dtypes`` blocked), and its entry points (the predictor, the
planner, the controllers, the trainers of the planning costs' networks and
the campaign runner, with ``--benchmark`` and, on the offline replay,
without it, and the robot runner ``sim/run_robot.py``) refuse to fall back
to the CPU when no card is present; random collection stays on the host."""

import os
import subprocess
import sys

import jax  # noqa: F401  (the suite keeps JAX on the CPU; see conftest)
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, pkgutil, sys
import visual_foresight_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax',
                                            'visual_foresight_tpu')))
# imported where they are needed: the card machine may lack them
bad += sorted({'h5py', 'cv2', 'google_crc32c', 'mujoco', 'imageio',
               'matplotlib'} & set(sys.modules))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 100 else 0)
'''


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the packages the card machine lacks, blocked outright: every module still
# imports (the TF1 codec, the RoboNet reader, the sawyer envs and the tools
# among them), and the RoboNet reader names h5py when it is built
_BLOCKED = r'''
import importlib, pkgutil, sys
for name in ('h5py', 'imageio', 'mujoco', 'cv2', 'google_crc32c',
             'ml_dtypes'):
    sys.modules[name] = None
import visual_foresight_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
from visual_foresight_torch.data import robonet_reader, tfrecord_io
assert tfrecord_io.crc32c_impl() is tfrecord_io.crc32c_numpy
try:
    robonet_reader.RoboNetTrajReader(sys.argv[1], 1)
except ImportError as e:
    assert 'h5py' in str(e), e
else:
    sys.exit('the RoboNet reader was built without h5py')
print(len(names))
'''

NEW_MODULES = ('prediction.tf1_bundle', 'prediction.tf1_import',
               'utils.profiling', 'utils.check_dataset',
               'training.visualize_predictions', 'data.robonet_reader',
               'envs.robot_envs.util.kinematics',
               'envs.robot_envs.sawyer.inverse_kinematics',
               'envs.mujoco_env.sawyer_env.arm_model',
               'envs.mujoco_env.sawyer_env.sawyer_arm_env',
               'envs.mujoco_env.sawyer_env.base_sawyer_env',
               'campaigns.collect_sawyer_arm',
               'campaigns.collect_sawyer_grasp',
               # the robot path
               'envs.robot_envs.robot_controller_interface',
               'envs.robot_envs.base_env', 'envs.robot_envs.autograsp_env',
               'envs.robot_envs.vanilla_env',
               'envs.robot_envs.grippers.gripper',
               'envs.robot_envs.grippers.sawyer.default_sawyer_gripper',
               'envs.robot_envs.grippers.baxter.default_baxter_gripper',
               'envs.robot_envs.grippers.kuka.default_kuka_gripper',
               'envs.robot_envs.grippers.weiss.wsg50_gripper',
               'envs.robot_envs.sawyer.control_util',
               'envs.robot_envs.sawyer.sawyer_impedance',
               'envs.robot_envs.baxter.baxter_impedance',
               'envs.robot_envs.baxter.inverse_kinematics',
               'envs.robot_envs.franka.franka_impedance',
               'envs.robot_envs.franka.inverse_kinematics',
               'envs.robot_envs.kuka.inverse_kinematics',
               'envs.robot_envs.kuka.kuka_interface',
               'envs.robot_envs.kuka.kuka_impedance',
               'envs.robot_envs.widowx.widowx_controller',
               'envs.robot_envs.util.topic_utils',
               'envs.robot_envs.util.camera_recorder',
               'envs.robot_envs.util.user_interface',
               'envs.robot_envs.util.log_cameras',
               'envs.robot_envs.util.get_points',
               'envs.robot_envs.util.launchers',
               'native.camera_client', 'native.start_cameras',
               'sim.run_robot', 'sim.util.camera_calib',
               'sim.util.record_motion',
               'campaigns.robot_sawyer_pixel_cost',
               # the campaign twins of the benchmarks and experiments/sim
               'campaigns.stand_ins', 'campaigns.ag_bench20_hard',
               'campaigns.ag_bench20_classifier',
               'campaigns.ag_bench20_ensemble',
               'campaigns.xz_bench20_ensemble',
               'campaigns.xz2c_bench20_registration',
               'campaigns.xz_bench20_nce', 'campaigns.xz_bench20_inverse',
               'campaigns.ag_bench20_inverse', 'campaigns.xz_bench20_random',
               'campaigns.xz2c_bench20_random', 'campaigns.ag_bench20_random',
               'campaigns.sim_autograsp_stochastic',
               'campaigns.sim_two_cam_registration',
               'campaigns.sim_2d_grasping_pixel_cost',
               'campaigns.sim_2d_grasping_nce_experiments',
               'campaigns.sim_2d_grasping_create_configs',
               'campaigns.sim_2d_grasping_generate_tasks',
               'campaigns.sim_ensemble_grasping',
               'campaigns.sim_ensemble_grasping_tasks',
               # the robot, RoboNet and collection twins and the root tools
               'campaigns.robot_sawyer_human_cem',
               'campaigns.robot_sawyer_registration_experiments',
               'campaigns.robot_sawyer_towel_classifier',
               'campaigns.robot_sawyer_mixed_objects_deformable',
               'campaigns.robot_sawyer_mixed_objects_hardobjects',
               'campaigns.robonet_franka', 'campaigns.robonet_pixel_cost',
               'campaigns.robonet_view_generalization_single_view',
               'campaigns.robonet_inverse_model_sawyer_one_step',
               'campaigns.collect_sim_cartgripper_grasp_r4_transport',
               'campaigns.collect_robot_sawyer_grasp',
               'campaigns.collect_robot_sawyer_towel_data_get_examples',
               'tools.dataset_reader_demo', 'tools.extract_sample_trajs',
               'tools.collect_campaign', 'tools.bench_model')


def test_port_imports_without_the_packages_the_card_machine_lacks(tmp_path):
    import pkgutil
    import visual_foresight_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + '.')}
    assert {'visual_foresight_torch.' + m for m in NEW_MODULES} <= names
    open(str(tmp_path / 'traj0.hdf5'), 'wb').close()
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', _BLOCKED, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the trainers of the planning costs' networks: one step at a tiny size
TRAINERS = {
    'train_gdn': ('train_gdn', 'train', []),
    'train_classifier': ('train_classifier', 'train_classifier', []),
    'train_nce': ('train_classifier', 'train_nce', ['--mode', 'nce']),
    'train_inverse': ('train_inverse', 'train_inverse',
                      ['--image_height', '32', '--image_width', '32']),
}


def _trainer(entry, **kw):
    import importlib
    module, fn, argv = TRAINERS[entry]
    module = importlib.import_module(
        'visual_foresight_torch.training.' + module)
    argv = ['--steps', '1', '--batch_size', '2', '--image_height', '16',
            '--image_width', '24'] + argv + \
        (['--device', kw['device']] if 'device' in kw else [])
    _, model = getattr(module, fn)(module.build_argparser().parse_args(argv))
    return next(model.parameters())


@pytest.mark.parametrize('entry', ['predictor', 'predictor_ag_r5f_v2',
                                   'planner', 'controller',
                                   'human_cem_controller'] + list(TRAINERS))
def test_entry_points_need_a_card_unless_told_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.planners.gaussian import make_action_spec
    from visual_foresight_torch.policy.cem_controllers import (
        PixelCostController)
    from visual_foresight_torch.policy.cem_controllers.human_cem_controller \
        import HumanCEMController
    from visual_foresight_torch.prediction.predictor import TorchPredictor
    spec = make_action_spec({'initial_std': 0.05, 'initial_std_lift': 0.15,
                             'initial_std_rot': 0.1, 'initial_std_grasp': 2,
                             'nactions': 2, 'repeat': 2}, 3)
    ag_params = {'adim': 3, 'sdim': 3, 'image_height': 16,
                 'image_width': 24}
    policy = {'T': 4, 'nactions': 2, 'repeat': 2, 'num_samples': 4,
              'minimum_selection': 2, 'rejection_sampling': False,
              'predictor_hparams': {'std_factor': 4, 'num_masks': 2,
                                    'enc_features': (8, 8, 8),
                                    'dtype': 'float32'}}
    make = {'predictor': lambda **kw: TorchPredictor(
                'unused', {'std_factor': 4}, **kw),
            # the latent model's export: built (not restored) from its
            # model_config.json
            'predictor_ag_r5f_v2': lambda **kw: TorchPredictor(
                os.path.join(REPO, 'visual_foresight_torch', 'weights',
                             'ag_r5f_v2'), {}, **kw),
            'planner': lambda **kw: FusedCEMPlanner(spec, 4, k_elite=2,
                                                    **kw),
            'controller': lambda **kw: PixelCostController(
                ag_params, dict(policy, **kw)),
            'human_cem_controller': lambda **kw: HumanCEMController(
                ag_params, dict(policy, **kw))}.get(
                    entry, lambda **kw: _trainer(entry, **kw))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        make()
    assert make(device='cpu').device.type == 'cpu'


@pytest.mark.parametrize('campaign,flags', [
    ('xz_bench20', ['--benchmark']), ('ag_bench20', ['--benchmark']),
    # data collection: the offline replay plans with the classifier
    ('offline_towel_classifier', [])],
    ids=['xz_bench20', 'ag_bench20', 'offline_towel_classifier'])
def test_campaign_runner_needs_a_card(campaign, flags):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    from visual_foresight_torch.sim import run
    config = os.path.join(REPO, 'visual_foresight_torch', 'campaigns',
                          campaign + '.py')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        run.main([config] + flags)


@pytest.mark.parametrize('twin', [
    'robot_sawyer_pixel_cost', 'robot_sawyer_registration_experiments',
    'robonet_franka', 'robonet_inverse_model_sawyer_one_step'])
def test_robot_runner_needs_a_card(twin):
    # run_robot refuses before it builds the agent: no camera node, no arm
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is valid')
    from visual_foresight_torch.sim import run, run_robot
    config = run.load_config(os.path.join(
        REPO, 'visual_foresight_torch', 'campaigns', twin + '.py'))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        run_robot.RobotEnvironment(config, benchmark=True)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        run_robot.main([os.path.join(REPO, 'visual_foresight_torch',
                                     'campaigns', twin + '.py'), 'vestri'])


@pytest.mark.parametrize('campaign,on_card', [
    ('collect_xz_r4', False), ('offline_towel_classifier', True),
    ('xz_bench20', True), ('ag_bench20', True),
    # the benchmarks' random baselines run on the host too
    ('xz_bench20_random', False), ('ag_bench20_inverse', True),
    ('sim_2d_grasping_generate_tasks', False),
    # the robot twins plan on the card, the collection twins on the host
    ('robot_sawyer_human_cem', True), ('robot_sawyer_towel_classifier', True),
    ('robonet_pixel_cost', True), ('robonet_inverse_model_sawyer_two_step',
                                   True),
    ('collect_sim_cartgripper_grasp_r4_transport_scripted', False),
    ('collect_robot_sawyer_correlated_noise_bottombias', False),
    ('collect_robot_sawyer_towel_data_get_examples', False)])
def test_runner_asks_for_the_card_only_for_planning_policies(campaign,
                                                             on_card):
    # random collection runs on the host, with or without a card
    from visual_foresight_torch.sim import run
    config = run.load_config(os.path.join(
        REPO, 'visual_foresight_torch', 'campaigns', campaign + '.py'))
    assert run.plans_on_device(config['policy']['type']) == on_card


def test_port_names_roadmap_items_by_name():
    """A message of the port that points at a queue of ``ROADMAP.md``
    names the item, not its number, which changes as items are struck."""
    import glob
    import re
    numbered = []
    for path in glob.glob(os.path.join(REPO, 'visual_foresight_torch', '**',
                                       '*.py'), recursive=True) + \
            [os.path.join(REPO, 'chip_smoke.py')]:
        with open(path) as f:
            numbered += [(path, m) for m in re.findall(
                r'ROADMAP\.md queue \d+, item \d+', f.read())]
    assert numbered == []
