"""Procedural 7-DoF Sawyer-arm MuJoCo scene.

The port's copy of ``visual_foresight_tpu/envs/mujoco_env/sawyer_env/
arm_model.py``: the same scene string, written by ``write_scene_xml`` into
the port's own ``envs/mujoco_env/assets/``.

The reference collects Sawyer sim data through robosuite: a full arm model
with an IK action space in a bin arena
(``visual_mpc/envs/mujoco_env/sawyer_env/robosuite_wrappers/SawyerIKEnv.py``,
``BinArena.py``).  Rather than vendoring robosuite's meshed model, the scene
here is *generated from the same kinematic chain the robot stack uses for
real-Sawyer IK* (``envs/robot_envs/sawyer/inverse_kinematics.CHAIN``): every
chain joint becomes a MuJoCo body + hinge whose origin/axis match the DLS
solver's frames exactly, so the solver's joint solutions are directly valid
actuator targets — one geometry source of truth for sim and robot.

Links render as capsules between consecutive joint origins (arm-in-frame
visuals, which the round-2 cartgripper-based stand-in could not produce), a
parallel-jaw gripper hangs from the flange, and the table/bin + object
machinery reuses the cartgripper scene conventions (``objects.xml`` include,
``finger{1,2}_surf`` touch sites, framepos sensors).
"""

import os

import numpy as np

from visual_foresight_torch.envs.robot_envs.sawyer.inverse_kinematics import (
    CHAIN)
from visual_foresight_torch.envs.robot_envs.util.kinematics import (
    quat_from_matrix, rpy_matrix)

# arm base placement in the world (tabletop plane is z ~= -0.06, objects at
# z ~= 0, same as the cartgripper family); -0.55 m back keeps the whole
# +-0.3 x +-0.35 object region inside the chain's dexterous down-pointing
# workspace (verified by tests/test_sawyer_arm.py)
BASE_POS = np.array([-0.55, 0.0, -0.06])
FINGER_RANGE = 0.04          # prismatic travel per finger; 0 = closed
FINGER_LENGTH = 0.06
_LINK_RADII = [0.050, 0.046, 0.042, 0.038, 0.034, 0.030, 0.026]
_ARM_RGBA = '0.85 0.1 0.1 1'         # rethink red
_DARK_RGBA = '0.25 0.25 0.28 1'


def _fmt(vals):
    return ' '.join('{:.6g}'.format(float(v)) for v in vals)


def _body_quat(rpy):
    return _fmt(quat_from_matrix(rpy_matrix(*rpy)))


def arm_xml_lines():
    """The nested arm body tree, one body per chain joint."""
    lines = []
    indent = '    '
    joints = CHAIN.joints
    for i, j in enumerate(joints):
        pad = indent * (i + 2)
        lines.append('{}<body name="link{}" pos="{}" quat="{}">'.format(
            pad, i, _fmt(j.origin_xyz), _body_quat(j.origin_rpy)))
        lines.append(
            '{}  <joint name="{}" type="hinge" axis="{}" limited="true" '
            'range="{:.6g} {:.6g}" damping="10"/>'.format(
                pad, j.name, _fmt(j.axis), j.lower, j.upper))
        # capsule to the next joint's origin (or the flange for the last)
        nxt = joints[i + 1].origin_xyz if i + 1 < len(joints) else \
            CHAIN._ee_T[:3, 3]
        if np.linalg.norm(nxt) > 0.02:
            lines.append(
                '{}  <geom type="capsule" fromto="0 0 0 {}" size="{:.4g}" '
                'rgba="{}" contype="0" conaffinity="0"/>'.format(
                    pad, _fmt(nxt), _LINK_RADII[i], _ARM_RGBA))
        else:
            lines.append(
                '{}  <geom type="sphere" size="{:.4g}" rgba="{}" '
                'contype="0" conaffinity="0"/>'.format(
                    pad, _LINK_RADII[i], _ARM_RGBA))

    # gripper: hand plate + two mirrored prismatic fingers with touch sites
    pad = indent * (len(joints) + 2)
    lines.append('{}<body name="hand" pos="{}">'.format(
        pad, _fmt(CHAIN._ee_T[:3, 3])))
    lines.append('{}  <geom type="box" size="0.05 0.02 0.012" rgba="{}" '
                 'contype="1" conaffinity="7"/>'.format(pad, _DARK_RGBA))
    lines.append('{}  <site name="ee_site" pos="0 0 {}" size="0.005"/>'
                 .format(pad, FINGER_LENGTH))
    for k, sign in ((1, 1.0), (2, -1.0)):
        lines.append('{}  <body name="finger{}" pos="{:.4g} 0 0.012">'
                     .format(pad, k, sign * 0.012))
        lines.append(
            '{}    <joint name="finger{}_joint" type="slide" axis="{:g} 0 0" '
            'limited="true" range="0 {:.4g}" damping="12"/>'.format(
                pad, k, sign, FINGER_RANGE))
        lines.append(
            '{}    <geom type="box" pos="0 0 {:.4g}" '
            'size="0.005 0.012 {:.4g}" rgba="{}" contype="{}" '
            'conaffinity="7" friction="1.5 0.1 0.02"/>'.format(
                pad, FINGER_LENGTH / 2, FINGER_LENGTH / 2, _DARK_RGBA,
                2 if k == 1 else 4))
        lines.append(
            '{}    <site name="finger{}_surf" pos="{:.4g} 0 {:.4g}" '
            'type="box" size="0.002 0.012 {:.4g}"/>'.format(
                pad, k, -sign * 0.005, FINGER_LENGTH / 2, FINGER_LENGTH / 2))
        lines.append('{}  </body>'.format(pad))
    lines.append('{}</body>'.format(pad))

    for i in range(len(joints) - 1, -1, -1):
        lines.append('{}</body>'.format(indent * (i + 2)))
    return lines


def scene_xml():
    """The full base scene (string): arena + cameras + arm + actuators."""
    head = """<mujoco model="sawyer_arm">
  <!-- 7-DoF Sawyer arm generated from envs/robot_envs/sawyer IK chain.
       qpos: 7 arm hinges, finger1, finger2, then object freejoints. -->
  <compiler inertiafromgeom="auto" angle="radian" eulerseq="XYZ"/>
  <option timestep="0.005" gravity="0 0 -9.81" iterations="50" integrator="Euler"/>
  <size njmax="6000" nconmax="6000"/>

  <default>
    <joint limited="false" damping="1"/>
    <geom contype="1" conaffinity="1" condim="3" friction=".5 .1 .1" density="1000" margin="0.002"/>
  </default>

  <worldbody>
    <camera name="cam0" mode="fixed" fovy="38" euler="0.7 0 0" pos="0 -1.1 1.2"/>
    <camera name="cam1" mode="fixed" fovy="38" euler="0.7 0 1.57" pos="1.1 0 1.2"/>

    <body name="base" pos="{base_pos}">
      <geom type="cylinder" size="0.09 0.06" pos="0 0 -0.06" rgba="{dark}"
            contype="0" conaffinity="0"/>
""".format(base_pos=_fmt(BASE_POS), dark=_DARK_RGBA)

    tail = """    </body>

    <body name="container" pos="0 0 -0.05">
      <geom name="border_front" type="box" pos="0 -.5 0" size=".5 .01 .1" rgba="0 .1 .9 .3" contype="7" conaffinity="7"/>
      <geom name="border_rear"  type="box" pos="0 .5 0"  size=".5 .01 .1" rgba="0 .1 .9 .3" contype="7" conaffinity="7"/>
      <geom name="border_right" type="box" pos=".5 0 0"  size=".01 .5 .1" rgba="0 .1 .9 .3" contype="7" conaffinity="7"/>
      <geom name="border_left"  type="box" pos="-.5 0 0" size=".01 .5 .1" rgba="0 .1 .9 .3" contype="7" conaffinity="7"/>
      <geom name="table" type="box" pos="0 0 -.01" size=".5 .5 .01" rgba="0 .9 0 1" contype="7" conaffinity="7"/>
    </body>

    <light name="light0" mode="fixed" directional="false" castshadow="true" pos="0 0 1"/>
  </worldbody>

  <include file="objects.xml"/>

  <actuator>
{actuators}
  </actuator>
</mujoco>
"""
    actuators = []
    for j in CHAIN.joints:
        actuators.append('    <position joint="{}" kp="600" '
                         'ctrlrange="{:.6g} {:.6g}"/>'.format(
                             j.name, j.lower, j.upper))
    for k in (1, 2):
        actuators.append('    <position joint="finger{}_joint" kp="120" '
                         'ctrlrange="0 {:.4g}"/>'.format(k, FINGER_RANGE))
    return head + '\n'.join(arm_xml_lines()) + tail.format(
        actuators='\n'.join(actuators))


def write_scene_xml(directory):
    """Write (or refresh) the static base scene into ``directory``; returns
    the path.  Content is deterministic, so concurrent workers writing it is
    benign (same bytes)."""
    path = os.path.join(directory, 'sawyer_arm_2cam.xml')
    content = scene_xml()
    try:
        with open(path) as f:
            if f.read() == content:
                return path
    except OSError:
        pass
    tmp = '{}.{}'.format(path, os.getpid())
    with open(tmp, 'w') as f:
        f.write(content)
    os.replace(tmp, path)
    return path
