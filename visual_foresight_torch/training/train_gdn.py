"""Goal-distance (registration) network training (PyTorch).

Counterpart of ``visual_foresight_tpu/training/train_gdn.py``, with its
names and flags (and ``--device``): frame pairs (I_t, I_{t+k}) sampled from
trajectories, the flow that warps I_t onto I_{t+k} predicted, and the
photometric L1 plus ``--smooth_weight`` times the flow's smoothness
minimized with Adam.  The numpy draws are the JAX trainer's, so the batches
are the same; the initial weights come from a torch generator.

CLI (``--device cpu`` runs on the CPU)::

    python -m visual_foresight_torch.training.train_gdn --data_dir <records> \\
        --model_dir <dir> [--steps N]

It writes ``params.npz`` and ``net_config.json`` to ``--model_dir``, which
``RegisterGtruthController`` reads as its ``gdn_path``.
"""

import argparse

import numpy as np
import torch

from visual_foresight_torch.models.gdn import GoalDistanceNet
from visual_foresight_torch.training import net_trainer


def smoothness_loss(flow):
    """Mean absolute difference of the NHWC flow along rows and columns."""
    dr = torch.diff(flow, dim=1)
    dc = torch.diff(flow, dim=2)
    return dr.abs().mean() + dc.abs().mean()


def make_loss_fn(model, smooth_weight=0.01):
    def loss_fn(current, reference):
        warped, flow, _ = model(current, reference)
        photo = (warped - reference).abs().mean()
        loss = photo + smooth_weight * smoothness_loss(flow)
        return loss, {'loss': loss, 'photometric': photo}
    return loss_fn


def frame_pair_batches(args):
    from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
    ds = BaseVideoDataset(args.data_dir, args.batch_size)
    rng = np.random.RandomState(args.seed)
    for batch in ds.numpy_iterator(keys=('images',)):
        images = batch['images'].astype(np.float32) / 255.0
        B, T = images.shape[:2]
        t0 = rng.randint(0, T - args.max_dt, size=B)
        dt = rng.randint(1, args.max_dt + 1, size=B)
        idx = np.arange(B)
        yield (images[idx, t0, args.camera],
               images[idx, np.minimum(t0 + dt, T - 1), args.camera])


def synthetic_pairs(args, seed=0):
    rng = np.random.RandomState(seed)
    h, w = args.image_height, args.image_width
    while True:
        cur = np.full((args.batch_size, h, w, 3), 0.1, np.float32)
        ref = np.full((args.batch_size, h, w, 3), 0.1, np.float32)
        for b in range(args.batch_size):
            r, c = rng.randint(2, h - 8), rng.randint(2, w - 8)
            dr, dc = rng.randint(-2, 3, 2)
            color = rng.rand(3)
            cur[b, r:r + 4, c:c + 4] = color
            ref[b, r + dr:r + dr + 4, c + dc:c + dc + 4] = color
        yield cur, ref


def train(args, init=None):
    """Train for ``args.steps`` steps on the records in ``--data_dir`` or
    on synthetic pairs; ``init`` (a flax tree) replaces the seeded initial
    weights.  Returns (history, model)."""
    model, device, tx = net_trainer.prepare(GoalDistanceNet(), args, init)
    step_fn = net_trainer.make_step(
        tx, make_loss_fn(model, args.smooth_weight))
    batches = frame_pair_batches(args) if args.data_dir else \
        synthetic_pairs(args)
    history = net_trainer.run(args, step_fn, batches, device)
    if args.model_dir:
        path = net_trainer.save_network(
            model, args.model_dir, {'features': list(model.features),
                                    'flow_scale': model.flow_scale},
            args.steps)
        print('saved GDN checkpoint to', path)
    return history, model


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument('--data_dir', type=str, default='')
    p.add_argument('--model_dir', type=str, default='')
    p.add_argument('--steps', type=int, default=2000)
    p.add_argument('--batch_size', type=int, default=32)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--image_height', type=int, default=48)
    p.add_argument('--image_width', type=int, default=64)
    p.add_argument('--max_dt', type=int, default=8)
    p.add_argument('--camera', type=int, default=0)
    p.add_argument('--smooth_weight', type=float, default=0.01)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--log_every', type=int, default=50)
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device ('cpu' runs on the CPU)")
    return p


if __name__ == '__main__':
    train(build_argparser().parse_args())
