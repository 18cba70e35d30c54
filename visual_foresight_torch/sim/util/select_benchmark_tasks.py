"""Build benchmark start/goal configurations from raw collection runs.

The reference generates benchmark tasks with ``CreateConfigAgent``
(``sim/util/config_agent.py``), which *simulates* a grasp-and-place per task —
expensive.  This tool implements the cheaper selection route: scan raw
trajectories (from a ``save_raw_images`` + ``save_reset_data`` collection
run), rank them by total object displacement, and re-emit the top K in the
exact on-disk format ``BenchmarkAgent._load_raw_data`` consumes:

    task_dir/traj_group0/traj{i}/
        images{c}/im_0.png   start frame
        images{c}/im_1.png   goal frame
        agent_data.pkl       {'reset_state': <initial scene state>}
        obs_dict.pkl         {'object_qpos': (2, nobj, 7) [start, goal]}

CLI::

    python -m visual_foresight_torch.sim.util.select_benchmark_tasks \
        <raw collection dir (containing train/traj_group*/traj*)> \
        <output task dir> [--ntasks 10] [--min_displacement 0.0]

The port's own copy of
``visual_foresight_tpu/sim/util/select_benchmark_tasks.py``.
"""

import argparse
import glob
import os
import pickle as pkl
import shutil

import numpy as np


def _traj_folders(collection_dir):
    pattern = os.path.join(collection_dir, 'traj_group*', 'traj*')
    return [p for p in sorted(glob.glob(pattern)) if os.path.isdir(p)]


def object_displacement(obs_dict):
    """Summed start->end planar displacement over all objects."""
    qpos = np.asarray(obs_dict['object_qpos'])       # (T, nobj, 7)
    return float(np.sum(np.linalg.norm(qpos[-1, :, :2] - qpos[0, :, :2],
                                       axis=-1)))


def load_traj(folder):
    with open(os.path.join(folder, 'agent_data.pkl'), 'rb') as f:
        agent_data = pkl.load(f)
    with open(os.path.join(folder, 'obs_dict.pkl'), 'rb') as f:
        obs_dict = pkl.load(f)
    return agent_data, obs_dict


def _task_object_first(qpos, reset_state):
    """Permute objects so the most-displaced one sits at index 0.

    Benchmarks run with ``ntask`` < num_objects: the policy plans for (and
    ``env.eval`` scores) the FIRST objects, so the task object must lead.
    The permutation is applied consistently to the trajectory's object qpos
    and both halves of the reset_state (scene-xml specs + the object block
    of ``qpos_all``).
    """
    disp = np.linalg.norm(qpos[-1, :, :2] - qpos[0, :, :2], axis=-1)
    order = np.argsort(-disp)
    if list(order) == sorted(order):
        return qpos, reset_state
    qpos = qpos[:, order]
    rs = dict(reset_state)
    if 'reset_xml' in rs and isinstance(rs['reset_xml'], (list, tuple)):
        rs['reset_xml'] = [rs['reset_xml'][i] for i in order]
    if 'qpos_all' in rs:
        qpos_all = np.array(rs['qpos_all'])
        nobj = qpos.shape[1]
        arm_dof = qpos_all.shape[0] - nobj * 7
        objs = qpos_all[arm_dof:].reshape(nobj, 7)[order]
        rs['qpos_all'] = np.concatenate([qpos_all[:arm_dof], objs.ravel()])
    return qpos, rs


def emit_task(out_folder, src_folder, agent_data, obs_dict):
    """Write one benchmark task folder (start frame + goal frame form)."""
    os.makedirs(out_folder)
    qpos = np.asarray(obs_dict['object_qpos'])
    qpos, reset_state = _task_object_first(qpos, agent_data['reset_state'])
    task_obs = {'object_qpos': np.stack([qpos[0], qpos[-1]])}
    with open(os.path.join(out_folder, 'obs_dict.pkl'), 'wb') as f:
        pkl.dump(task_obs, f)
    with open(os.path.join(out_folder, 'agent_data.pkl'), 'wb') as f:
        pkl.dump({'reset_state': reset_state}, f)

    cams = sorted(glob.glob(os.path.join(src_folder, 'images*')))
    for cam_dir in cams:
        cam_name = os.path.basename(cam_dir)
        frames = sorted(
            glob.glob(os.path.join(cam_dir, 'im_*.png')),
            key=lambda p: int(os.path.basename(p)[3:-4]))
        dst_cam = os.path.join(out_folder, cam_name)
        os.makedirs(dst_cam)
        shutil.copyfile(frames[0], os.path.join(dst_cam, 'im_0.png'))
        shutil.copyfile(frames[-1], os.path.join(dst_cam, 'im_1.png'))


def select_tasks(collection_dir, out_dir, ntasks=10, min_displacement=0.0):
    """Rank raw trajectories by object displacement; emit the top ``ntasks``
    as benchmark configs under ``out_dir``.  Returns the chosen folders."""
    scored = []
    for folder in _traj_folders(collection_dir):
        try:
            agent_data, obs_dict = load_traj(folder)
        except (FileNotFoundError, KeyError) as e:
            print('skipping {}: {}'.format(folder, e))
            continue
        if 'reset_state' not in agent_data:
            print('skipping {}: no reset_state '
                  '(collect with save_reset_data)'.format(folder))
            continue
        disp = object_displacement(obs_dict)
        if disp >= min_displacement:
            scored.append((disp, folder, agent_data, obs_dict))

    scored.sort(key=lambda x: -x[0])
    chosen = scored[:ntasks]
    if len(chosen) < ntasks:
        print('WARNING: only {} of {} requested tasks available'.format(
            len(chosen), ntasks))

    group_dir = os.path.join(out_dir, 'traj_group0')
    if os.path.exists(group_dir):
        shutil.rmtree(group_dir)
    for i, (disp, src, agent_data, obs_dict) in enumerate(chosen):
        emit_task(os.path.join(group_dir, 'traj{}'.format(i)),
                  src, agent_data, obs_dict)
        print('task {}: displacement {:.3f} from {}'.format(i, disp, src))
    return [c[1] for c in chosen]


def main():
    p = argparse.ArgumentParser(
        description='select benchmark start/goal tasks from raw trajectories')
    p.add_argument('collection_dir',
                   help='dir containing traj_group*/traj* raw folders')
    p.add_argument('out_dir', help='benchmark task dir to create')
    p.add_argument('--ntasks', type=int, default=10)
    p.add_argument('--min_displacement', type=float, default=0.0)
    args = p.parse_args()
    select_tasks(args.collection_dir, args.out_dir, args.ntasks,
                 args.min_displacement)


if __name__ == '__main__':
    main()
