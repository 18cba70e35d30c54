"""Inverse-model training (PyTorch): (frame_t, frame_{t+plan_T}, context)
-> actions.

Counterpart of ``visual_foresight_tpu/training/train_inverse.py``, with its
names and flags (and ``--device``): windows sampled from trajectories, the
goal frame ``plan_T`` steps ahead, the action-sequence MSE minimized with
Adam beside the zero-prediction baseline ``zero_mse``, and a checkpoint
every ``--ckpt_every`` steps.  The numpy draws are the JAX trainer's, so
the batches are the same; the initial weights come from a torch generator.

CLI (``--device cpu`` runs on the CPU)::

    python -m visual_foresight_torch.training.train_inverse \\
        --data_dir <records> --model_dir <dir> --adim 3 [--steps N]

It writes ``params.npz`` and ``net_config.json`` to ``--model_dir``, which
``InvModelBaseController`` reads as its ``model_params_path``.
"""

import argparse

import numpy as np

from visual_foresight_torch.models.inverse import InverseNet
from visual_foresight_torch.training import net_trainer


def window_batches(args, seed=None):
    """Sample (current, goal, context frames, context actions, target
    actions) windows from collected trajectories."""
    from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
    ds = BaseVideoDataset(args.data_dir, args.batch_size)
    rng = np.random.RandomState(args.seed if seed is None else seed)
    nc, pt, cam = args.num_context, args.plan_T, args.camera
    for batch in ds.numpy_iterator(keys=('images', 'actions')):
        images = batch['images'].astype(np.float32) / 255.0
        actions = batch['actions'].astype(np.float32)[..., :args.adim]
        b, T = images.shape[:2]
        if T < nc + pt + 1:
            raise ValueError(
                'trajectories too short: T=%d < num_context+plan_T+1=%d'
                % (T, nc + pt + 1))
        ts = rng.randint(nc, T - pt, size=b)
        idx = np.arange(b)
        cur = images[idx, ts, cam]
        goal = images[idx, ts + pt, cam]
        ctx_f = np.stack([images[idx, ts - nc + i, cam] for i in range(nc)],
                         axis=1)
        ctx_a = np.stack([actions[idx, ts - nc + i] for i in range(nc)],
                         axis=1)
        tgt = np.stack([actions[idx, ts + i] for i in range(pt)], axis=1)
        yield cur, goal, ctx_f, ctx_a, tgt


def synthetic_window_batches(args, seed=0):
    """Synthetic task: a square moves by each action's (dx, dy); the
    inverse model must read the displacement from (current, goal).  A model
    that ignores the frames cannot beat the zero-prediction baseline."""
    rng = np.random.RandomState(seed)
    h, w = args.image_height, args.image_width
    nc, pt = args.num_context, args.plan_T
    step_px = 2.0

    def draw(r, c):
        f = np.zeros((h, w, 3), np.float32)
        r, c = int(round(r)) % (h - 8), int(round(c)) % (w - 8)
        f[r:r + 8, c:c + 8] = 1.0
        return f

    while True:
        cur = np.empty((args.batch_size, h, w, 3), np.float32)
        goal = np.empty_like(cur)
        ctx_f = np.empty((args.batch_size, nc, h, w, 3), np.float32)
        ctx_a = rng.uniform(-1, 1, (args.batch_size, nc, args.adim)) \
            .astype(np.float32)
        tgt = np.zeros((args.batch_size, pt, args.adim), np.float32)
        for i in range(args.batch_size):
            r, c = rng.randint(8, h - 16), rng.randint(8, w - 16)
            # constant per-window action: displacement / plan_T
            a = rng.uniform(-1, 1, 2).astype(np.float32)
            tgt[i, :, :2] = a
            for j in range(nc):
                ctx_f[i, j] = draw(r - (nc - j) * a[0] * step_px,
                                   c - (nc - j) * a[1] * step_px)
            cur[i] = draw(r, c)
            goal[i] = draw(r + pt * a[0] * step_px, c + pt * a[1] * step_px)
        yield cur, goal, ctx_f, ctx_a, tgt


def inverse_loss_fn(model):
    def loss_fn(cur, goal, ctx_f, tgt):
        pred = model(cur, goal, ctx_f)
        loss = (pred - tgt).square().mean()
        # zero-prediction baseline: what "ignore the frames" scores
        return loss, {'loss': loss, 'zero_mse': tgt.square().mean()}
    return loss_fn


def train_inverse(args, init=None):
    """Train for ``args.steps`` steps on windows of the records in
    ``--data_dir`` or on the synthetic task, saving every
    ``--ckpt_every`` steps and at the end; ``init`` (a flax tree) replaces
    the seeded initial weights.  Returns (history, model)."""
    model, device, tx = net_trainer.prepare(
        InverseNet(args.adim, args.plan_T, args.num_context), args, init)
    step_fn = net_trainer.make_step(tx, inverse_loss_fn(model))
    config = {'adim': args.adim, 'plan_T': args.plan_T,
              'num_context': args.num_context}
    windows = window_batches(args) if args.data_dir else \
        synthetic_window_batches(args)
    # the context actions are drawn but not a network input
    batches = ((cur, goal, ctx_f, tgt)
               for cur, goal, ctx_f, _, tgt in windows)
    ckpt_every = getattr(args, 'ckpt_every', 0)

    def checkpoint(step):
        # periodic checkpoints: a run cut by a wall-clock budget still
        # leaves a servable model behind
        if args.model_dir and ckpt_every and step and \
                step % ckpt_every == 0:
            net_trainer.save_network(model, args.model_dir, config, step)

    history = net_trainer.run(args, step_fn, batches, device,
                              on_step=checkpoint)
    if args.model_dir:
        print('saved to', net_trainer.save_network(
            model, args.model_dir, config, args.steps))
    return history, model


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--data_dir', default='',
                   help='records dir; synthetic task when empty')
    p.add_argument('--model_dir', default='')
    p.add_argument('--steps', type=int, default=3000)
    p.add_argument('--batch_size', type=int, default=32)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--adim', type=int, default=3)
    p.add_argument('--plan_T', type=int, default=7)
    p.add_argument('--num_context', type=int, default=2)
    p.add_argument('--camera', type=int, default=0)
    p.add_argument('--image_height', type=int, default=48)
    p.add_argument('--image_width', type=int, default=64)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--log_every', type=int, default=50)
    p.add_argument('--ckpt_every', type=int, default=500)
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device ('cpu' runs on the CPU)")
    return p


def main():
    train_inverse(build_argparser().parse_args())


if __name__ == '__main__':
    main()
