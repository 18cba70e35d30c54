"""Procedural MuJoCo scene generation.

Re-implements the capability of reference
``visual_mpc/envs/mujoco_env/util/create_xml.py:45-267`` for MuJoCo 3.x: each
trajectory gets freshly sampled objects (random colored L-blocks or cubes,
optional STL meshes), written as an include file next to the base scene XML.
The sampled object property dicts double as the ``reset_xml`` payload stored in
``reset_state`` so benchmark runs can rebuild the exact same scene.

Sensor layout contract (consumed by ``BaseCartgripperEnv._get_obs``):
``sensordata[0:2]`` finger touch (when enabled) followed by one 3-vector
framepos per object.
"""

import glob
import os
import random
import xml.etree.ElementTree as ET

import numpy as np

_AUTO_GEN_SUBDIR = 'auto_gen'


def _auto_gen_dir(base_filename):
    d = os.path.join(os.path.dirname(os.path.abspath(base_filename)), _AUTO_GEN_SUBDIR)
    os.makedirs(d, exist_ok=True)
    return d


def _sample_object_spec(minlen, maxlen, object_meshes):
    spec = {
        'color1': np.random.uniform(0.3, 1.0, 3),
        'color2': np.random.uniform(0.3, 1.0, 3),
        'l1': np.random.uniform(minlen, maxlen),
        'l2': np.random.uniform(minlen, maxlen),
        'pos2': None,
    }
    spec['pos2'] = np.random.uniform(0.01, spec['l1'])
    if object_meshes is not None:
        spec['chosen_mesh'] = random.choice(object_meshes)
    return spec


def _rgba(color):
    return '{:.4f} {:.4f} {:.4f} 1'.format(*color)


def _mesh_assets_for(spec, mesh_dir, maxlen, asset_el, loaded):
    """Load an STL mesh, rescale it by bounding box to maxlen, emit asset entries.

    Returns (mesh_name, half_height). Requires numpy-stl; callers must gate on
    availability (reference used numpy-stl the same way).
    """
    from stl import mesh as stl_mesh  # optional dep, only for mesh objects

    name = spec['chosen_mesh']
    if name in loaded:
        return loaded[name]

    stl_files = glob.glob(os.path.join(mesh_dir, name, '*.stl'))
    hull_files = [f for f in stl_files if 'Shape_IndexedFaceSet' in f]
    main_files = [f for f in stl_files if f not in hull_files]
    if not main_files:
        raise ValueError('no STL found for mesh {} under {}'.format(name, mesh_dir))
    object_file = main_files[0]

    m = stl_mesh.Mesh.from_file(object_file)
    mins = m.points.reshape(-1, 3).min(axis=0)
    maxs = m.points.reshape(-1, 3).max(axis=0)
    scale = maxlen / float(np.max(maxs - mins))

    ET.SubElement(asset_el, 'mesh', name='mesh_{}'.format(name), file=object_file,
                  scale='{0} {0} {0}'.format(scale))
    for k, hull in enumerate(hull_files):
        ET.SubElement(asset_el, 'mesh', name='mesh_{}_hull{}'.format(name, k),
                      file=hull, scale='{0} {0} {0}'.format(scale))
    half_height = 0.5 * scale * (maxs[2] - mins[2])
    loaded[name] = ('mesh_{}'.format(name), len(hull_files), half_height)
    return loaded[name]


def create_object_xml(base_filename, num_objects, object_mass, friction_params,
                      object_meshes, finger_sensors, maxlen, minlen, reset_xml,
                      obj_classname=None, block_height=0.03, block_width=0.03,
                      cube_objs=False):
    """Write ``auto_gen/objects_<pid>.xml`` next to the base scene and return the
    list of sampled object-spec dicts (the reproducible ``reset_xml``)."""
    f_sliding, f_torsion, f_rolling = friction_params
    friction_str = '{} {} {}'.format(f_sliding, f_torsion, f_rolling)

    root = ET.Element('mujoco', model='auto_objects')

    sensor_el = ET.SubElement(root, 'sensor')
    if finger_sensors:
        ET.SubElement(sensor_el, 'touch', name='finger1_sensor', site='finger1_surf')
        ET.SubElement(sensor_el, 'touch', name='finger2_sensor', site='finger2_surf')

    world = ET.SubElement(root, 'worldbody')
    asset_el = None
    loaded_meshes = {}

    if reset_xml is not None:
        specs = reset_xml
    else:
        specs = [_sample_object_spec(minlen, maxlen, object_meshes)
                 for _ in range(num_objects)]

    for i, spec in enumerate(specs):
        obj_name = 'object{}'.format(i)
        body_kwargs = {'name': obj_name, 'pos': '0 0 0'}
        if obj_classname is not None:
            body_kwargs['childclass'] = obj_classname
        body = ET.SubElement(world, 'body', **body_kwargs)
        ET.SubElement(body, 'freejoint', name='{}_joint'.format(obj_name))

        # contype/conaffinity 7 so objects collide with gripper body (1),
        # finger1 (2), finger2 (4) and the container (7)
        geom_common = dict(friction=friction_str, mass=str(object_mass),
                           contype='7', conaffinity='7')
        if object_meshes is not None:
            if asset_el is None:
                asset_el = ET.SubElement(root, 'asset')
            mesh_dir = os.path.join(os.path.dirname(os.path.abspath(base_filename)),
                                    '..', 'meshes')
            mesh_name, n_hulls, half_h = _mesh_assets_for(
                spec, mesh_dir, maxlen, asset_el, loaded_meshes)
            pos = '0 0 {}'.format(half_h)
            if n_hulls:
                ET.SubElement(body, 'geom', type='mesh', mesh=mesh_name, pos=pos,
                              rgba=_rgba(spec['color1']), contype='0',
                              conaffinity='0', mass=str(object_mass))
                for k in range(n_hulls):
                    ET.SubElement(body, 'geom', type='mesh',
                                  mesh='{}_hull{}'.format(mesh_name, k), pos=pos,
                                  rgba='0 1 0 0', **geom_common)
            else:
                ET.SubElement(body, 'geom', type='mesh', mesh=mesh_name, pos=pos,
                              rgba=_rgba(spec['color1']), **geom_common)
        elif cube_objs:
            ET.SubElement(body, 'geom', type='box',
                          size='{0} {0} {0}'.format(spec['l1']),
                          rgba=_rgba(spec['color1']), **geom_common)
        else:
            # two-box "L" block: a bar along y plus a perpendicular stub at a
            # random offset along the bar, the default clutter object
            ET.SubElement(body, 'geom', type='box',
                          size='{} {} {}'.format(block_width, spec['l1'],
                                                 block_height),
                          rgba=_rgba(spec['color1']), **geom_common)
            ET.SubElement(body, 'geom', type='box',
                          pos='{} {} 0'.format(spec['l2'], spec['pos2']),
                          size='{} {} {}'.format(spec['l2'], block_width,
                                                 block_height),
                          rgba=_rgba(spec['color2']), **geom_common)

        ET.SubElement(sensor_el, 'framepos', name='{}_pos'.format(obj_name),
                      objtype='body', objname=obj_name)

    out_path = os.path.join(_auto_gen_dir(base_filename),
                            'objects_{}.xml'.format(os.getpid()))
    ET.ElementTree(root).write(out_path)
    return specs


def create_root_xml(base_filename):
    """Produce the per-process root scene: the base XML with its
    ``<include file="objects.xml"/>`` retargeted at this process's generated
    objects file. Returns the generated root path."""
    with open(base_filename) as f:
        content = f.read()
    pid = os.getpid()
    content = content.replace('objects.xml',
                              os.path.join(_AUTO_GEN_SUBDIR,
                                           'objects_{}.xml'.format(pid)))
    out_path = os.path.join(os.path.dirname(os.path.abspath(base_filename)),
                            'auto_gen_root_{}.xml'.format(pid))
    with open(out_path, 'w') as f:
        f.write(content)
    return out_path


def clean_xml(root_path):
    """Remove the generated root + objects files for this process."""
    try:
        os.remove(root_path)
    except OSError:
        pass
    obj_path = os.path.join(os.path.dirname(root_path), _AUTO_GEN_SUBDIR,
                            'objects_{}.xml'.format(os.getpid()))
    try:
        os.remove(obj_path)
    except OSError:
        pass
