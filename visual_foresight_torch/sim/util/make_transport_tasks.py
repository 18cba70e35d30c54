"""Generate grasp-transport benchmark tasks by goal teleportation.

The displacement-selection route (``select_benchmark_tasks``) can only
propose goals a RANDOM policy already reached, which caps task difficulty —
autograsp random rollouts rarely carry an object far, so selected sets have
~0.15 m initial distances.  This tool implements the reference's
``CreateConfigAgent`` semantics (``sim/util/config_agent.py``: snapshot,
teleport objects, snapshot again) with an explicit minimum-distance goal
sample: start = a collected reset state, goal = the task object teleported
to a uniformly sampled resting pose >= ``--min_dist`` away.

Emits the exact on-disk format ``BenchmarkAgent._load_raw_data`` consumes
(same contract as ``select_benchmark_tasks``):

    task_dir/traj_group0/traj{i}/
        images{c}/im_0.png   start frame
        images{c}/im_1.png   goal frame
        agent_data.pkl       {'reset_state': <initial scene state>}
        obs_dict.pkl         {'object_qpos': (2, nobj, 7) [start, goal]}

CLI::

    python -m visual_foresight_torch.sim.util.make_transport_tasks \
        <collection_hparams.py> <raw collection dir> <output task dir> \
        [--ntasks 20] [--min_dist 0.25] [--seed 0]

The port's own copy of
``visual_foresight_tpu/sim/util/make_transport_tasks.py``.
"""

import argparse
import glob
import importlib.machinery
import os
import pickle as pkl

import numpy as np


def _traj_folders(collection_dir):
    pattern = os.path.join(collection_dir, 'traj_group*', 'traj*')
    return [p for p in sorted(glob.glob(pattern)) if os.path.isdir(p)]


def _load_env(hparams_path, reset_state=None):
    """Construct the collection env; ``reset_state`` must be passed at
    CONSTRUCTION so the scene XML (object sizes/meshes/colors) matches the
    saved qpos — ``reset()`` alone restores joint state into whatever scene
    the env was built with (same contract as ``GeneralAgent._setup_world``)."""
    mod = importlib.machinery.SourceFileLoader(
        'task_gen_conf', hparams_path).load_module()
    env_cls, env_params = mod.config['agent']['env']
    return env_cls(dict(env_params), reset_state)


def _snapshot(obs, cams):
    imgs = obs['images']
    return [np.asarray(imgs[c]) for c in range(cams)]


def _write_task(out_folder, reset_state, frames_start, frames_goal, qpos2):
    import cv2
    os.makedirs(out_folder)
    for c, (s, g) in enumerate(zip(frames_start, frames_goal)):
        d = os.path.join(out_folder, 'images{}'.format(c))
        os.makedirs(d)
        cv2.imwrite(os.path.join(d, 'im_0.png'), s[:, :, ::-1])
        cv2.imwrite(os.path.join(d, 'im_1.png'), g[:, :, ::-1])
    with open(os.path.join(out_folder, 'agent_data.pkl'), 'wb') as f:
        pkl.dump({'reset_state': reset_state}, f)
    with open(os.path.join(out_folder, 'obs_dict.pkl'), 'wb') as f:
        pkl.dump({'object_qpos': qpos2}, f)


def generate(env, reset_state, min_dist, rng, settle_steps=2000):
    """One task: reset to ``reset_state``, settle, snapshot, teleport object
    0 to a resting pose >= min_dist away (planar, clear of the arm and the
    other objects), settle, snapshot.  Raises ValueError if no
    non-interpenetrating goal settles close to its target."""
    obs, rs = env.reset(reset_state)
    nq = env._data.qpos.shape[0]
    base = env._n_joints
    nobj = (nq - base) // 7
    # settle the START state too: reset drops objects from above
    for _ in range(settle_steps):
        env._sim_step()
    obs = env.current_obs()
    ncam = obs['images'].shape[0]
    frames_start = _snapshot(obs, ncam)
    qpos_start = np.asarray(obs['object_qpos']).copy()
    if np.any(np.abs(qpos_start[:, :3]) > 1.5):
        # a restored reset state occasionally interpenetrates and explodes
        # (or an object tunnels through the floor) — unusable as a task
        raise ValueError('start state unstable after settle')

    lo = np.asarray(env.low_bound[:2], np.float32)
    hi = np.asarray(env.high_bound[:2], np.float32)
    margin = 0.05 * (hi - lo)
    start_xy = qpos_start[0, :2]
    arm_xy = np.asarray(env._data.qpos[:2]).copy()
    others = qpos_start[1:, :2] if nobj > 1 else np.zeros((0, 2))

    saved_qpos = np.asarray(env._data.qpos).copy()
    for _ in range(60):
        target = rng.uniform(lo + margin, hi - margin)
        if np.linalg.norm(target - start_xy) < min_dist:
            continue
        if np.linalg.norm(target - arm_xy) < 0.12:
            continue                      # would interpenetrate the gripper
        if others.size and np.min(
                np.linalg.norm(others - target[None], axis=-1)) < 0.1:
            continue
        env._data.qpos[:] = saved_qpos
        env._data.qvel[:] = 0.0
        env._data.qpos[base:base + 2] = target
        env._data.qpos[base + 2] = qpos_start[0, 2] + 0.02
        for _ in range(settle_steps):
            env._sim_step()
        settled = np.asarray(env._data.qpos[base:base + 3]).copy()
        all_obj = np.asarray(env._data.qpos[base:base + 7 * nobj]
                             ).reshape(nobj, 7)[:, :3]
        bystanders_ok = nobj == 1 or (
            # the teleported object must not eject or displace the others
            np.all(np.abs(all_obj[1:]) < 1.5) and
            np.all(np.linalg.norm(all_obj[1:, :2] - qpos_start[1:, :2],
                                  axis=-1) < 0.05))
        if np.linalg.norm(settled[:2] - target) < 0.05 and \
                abs(settled[2]) < 1.0 and bystanders_ok and \
                np.linalg.norm(settled[:2] - start_xy) >= min_dist:
            break
    else:
        raise ValueError('no stable goal placement >= {} found'.format(
            min_dist))

    obs_goal = env.current_obs()
    frames_goal = _snapshot(obs_goal, ncam)
    qpos_goal = np.asarray(obs_goal['object_qpos']).copy()
    qpos2 = np.stack([qpos_start, qpos_goal])
    dist = float(np.linalg.norm(qpos_goal[0, :2] - qpos_start[0, :2]))
    return rs, frames_start, frames_goal, qpos2, dist


def main():
    ap = argparse.ArgumentParser(
        description='generate grasp-transport benchmark tasks by goal '
                    'teleportation')
    ap.add_argument('hparams', help='collection hparams.py defining the env')
    ap.add_argument('collection_dir',
                    help='raw run with agent_data.pkl reset states')
    ap.add_argument('out_dir')
    ap.add_argument('--ntasks', type=int, default=20)
    ap.add_argument('--min_dist', type=float, default=0.25)
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args()

    rng = np.random.RandomState(args.seed)
    folders = _traj_folders(args.collection_dir)
    if not folders:
        raise SystemExit('no raw trajs under ' + args.collection_dir)

    group = os.path.join(args.out_dir, 'traj_group0')
    os.makedirs(group, exist_ok=True)
    made = 0
    dists = []
    for folder in folders:
        if made >= args.ntasks:
            break
        with open(os.path.join(folder, 'agent_data.pkl'), 'rb') as f:
            reset_state = pkl.load(f)['reset_state']
        try:
            env = _load_env(args.hparams, reset_state)
            rs, fs, fg, qpos2, dist = generate(env, reset_state,
                                               args.min_dist, rng)
            del env
        except ValueError as e:
            print('skip {}: {}'.format(folder, e))
            continue
        _write_task(os.path.join(group, 'traj{}'.format(made)),
                    rs, fs, fg, qpos2)
        print('task {}: initial dist {:.3f} from {}'.format(
            made, dist, folder))
        dists.append(dist)
        made += 1
    print('made {} tasks, mean initial dist {:.3f}'.format(
        made, float(np.mean(dists))))


if __name__ == '__main__':
    main()
