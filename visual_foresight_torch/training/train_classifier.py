"""Success-classifier and NCE-embedding training (PyTorch).

Counterpart of ``visual_foresight_tpu/training/train_classifier.py``, with
its names and flags (and ``--device``).  ``--mode classifier`` trains the
goal-conditioned ``SuccessClassifier`` with a weighted sigmoid
cross-entropy: ``--label_mode goal`` pairs frames with goal frames
self-supervised from trajectories (ambiguous negatives weighted 0), ``lift``
reads the ``goal_reached`` metadata.  ``--mode nce`` trains ``NCEEmbedding``
with InfoNCE over (frame_t, frame_{t+1}) positives at temperature 0.1.
The numpy draws are the JAX trainer's, so the batches are the same; the
initial weights come from a torch generator.

CLI (``--device cpu`` runs on the CPU)::

    python -m visual_foresight_torch.training.train_classifier \\
        --data_dir <records> --model_dir <dir> [--mode classifier|nce]

It writes ``params.npz`` and ``net_config.json`` to ``--model_dir``, which
``ClassifierController`` (``classifier_path``) and ``NCECostController``
(``embedding_path``) read.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from visual_foresight_torch.models.classifier import (FEATURES,
                                                      NCEEmbedding,
                                                      SuccessClassifier)
from visual_foresight_torch.training import net_trainer

NCE_TEMPERATURE = 0.1


def classifier_batches(args):
    """Legacy 'lift' labels: goal_reached metadata, first frame as the goal
    proxy.  Position-blind by construction; ``--label_mode goal`` is the
    recipe."""
    from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
    ds = BaseVideoDataset(args.data_dir, args.batch_size)
    for batch in ds.numpy_iterator(keys=('images', 'goal_reached')):
        images = batch['images'].astype(np.float32) / 255.0
        labels = np.asarray(batch['goal_reached']).reshape(-1).astype(
            np.float32)
        # final frame vs first frame (as goal proxy)
        yield (images[:, -1, args.camera], images[:, 0, args.camera], labels,
               np.ones_like(labels))


def goal_conditioned_batches(args, seed=None):
    """Goal-conditioned labels made self-supervised from trajectories (the
    reference's towel classifier, ``experiments/sawyer/towel_classifier/
    conf.py:18``):

    * positive: a late frame paired with a goal frame from the same
      trajectory's tail;
    * temporal negative: the first frame against the same trajectory's
      final frame;
    * cross negative: a late frame against another trajectory's goal.

    Negatives whose two frames differ by less than
    ``--ambiguous_pixel_diff`` (mean absolute pixel gap) get weight 0.
    """
    from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
    ds = BaseVideoDataset(args.data_dir, args.batch_size)
    rng = np.random.RandomState(args.seed if seed is None else seed)
    min_diff = args.ambiguous_pixel_diff
    for batch in ds.numpy_iterator(keys=('images',)):
        images = batch['images'].astype(np.float32) / 255.0
        b, T = images.shape[:2]
        cur = np.empty((b,) + images.shape[3:], np.float32)
        goal = np.empty_like(cur)
        labels = np.zeros(b, np.float32)
        weights = np.ones(b, np.float32)
        kinds = rng.randint(0, 4, b)       # 0/1 positive, 2 temporal, 3 cross
        perm = rng.permutation(b)
        for i in range(b):
            cam = args.camera
            if kinds[i] <= 1:
                t_cur = T - 1 - rng.randint(0, min(2, T - 1))
                t_goal = T - 1 - rng.randint(0, min(3, T - 1))
                cur[i], goal[i] = images[i, t_cur, cam], images[i, t_goal, cam]
                labels[i] = 1.0
            elif kinds[i] == 2:
                cur[i], goal[i] = images[i, 0, cam], images[i, T - 1, cam]
            else:
                j = perm[i] if perm[i] != i else (i + 1) % b
                cur[i], goal[i] = images[i, T - 1, cam], images[j, T - 1, cam]
            if labels[i] == 0.0 and \
                    np.abs(cur[i] - goal[i]).mean() < min_diff:
                weights[i] = 0.0           # ambiguous negative
        yield cur, goal, labels, weights


def synthetic_goal_batches(args, seed=0):
    """Synthetic goal-conditioned task: a bright square at a random cell;
    success iff the frame's square sits at the GOAL's cell, which a
    position-blind classifier cannot learn."""
    rng = np.random.RandomState(seed)
    h, w = args.image_height, args.image_width
    # shrink the square on tiny frames so at least two DISJOINT cells exist
    s = 8 if min(h, w) >= 16 else max(2, min(h, w) // 2)
    cells = [(r, c) for r in range(0, h - s, 12) for c in range(0, w - s, 16)]
    if len(cells) < 2:
        # corner cells: disjoint by construction since s <= min(h, w) // 2
        cells = sorted({(r, c) for r in (0, max(h - s, 0))
                        for c in (0, max(w - s, 0))})
    assert len(cells) >= 2, 'frame too small for a goal-conditioned task'
    while True:
        cur = rng.rand(args.batch_size, h, w, 3).astype(np.float32) * 0.2
        goal = rng.rand(args.batch_size, h, w, 3).astype(np.float32) * 0.2
        labels = (rng.rand(args.batch_size) > 0.5).astype(np.float32)
        for i in range(args.batch_size):
            gi = rng.randint(len(cells))
            ci = gi if labels[i] > 0.5 else \
                (gi + 1 + rng.randint(len(cells) - 1)) % len(cells)
            r, c = cells[ci]
            cur[i, r:r + s, c:c + s] += 0.7
            r, c = cells[gi]
            goal[i, r:r + s, c:c + s] += 0.7
        yield cur, goal, labels, np.ones_like(labels)


def synthetic_classifier_batches(args, seed=0):
    rng = np.random.RandomState(seed)
    h, w = args.image_height, args.image_width
    while True:
        frames = rng.rand(args.batch_size, h, w, 3).astype(np.float32) * 0.2
        labels = (rng.rand(args.batch_size) > 0.5).astype(np.float32)
        frames[labels > 0.5, :8, :8] += 0.7   # learnable success cue
        goals = rng.rand(args.batch_size, h, w, 3).astype(np.float32) * 0.2
        yield frames, goals, labels, np.ones_like(labels)


def sigmoid_binary_cross_entropy(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy``, element by element."""
    return -labels * F.logsigmoid(logits) - \
        (1.0 - labels) * F.logsigmoid(-logits)


def classifier_loss_fn(model):
    def loss_fn(frames, goals, labels, weights):
        logits = model(frames, goals)
        per = sigmoid_binary_cross_entropy(logits, labels) * weights
        total = torch.clamp(weights.sum(), min=1.0)
        loss = per.sum() / total
        acc = (((logits > 0) == (labels > 0.5)) * weights).sum() / total
        return loss, {'loss': loss, 'acc': acc}
    return loss_fn


def train_classifier(args, init=None):
    """Train the success classifier; ``init`` (a flax tree) replaces the
    seeded initial weights.  Returns (history, model)."""
    model, device, tx = net_trainer.prepare(SuccessClassifier(), args, init)
    step_fn = net_trainer.make_step(tx, classifier_loss_fn(model))
    if args.data_dir:
        batches = goal_conditioned_batches(args) \
            if args.label_mode == 'goal' else classifier_batches(args)
    else:
        batches = synthetic_goal_batches(args) \
            if args.label_mode == 'goal' else \
            synthetic_classifier_batches(args)
    history = net_trainer.run(args, step_fn, batches, device)
    if args.model_dir:
        print('saved to', net_trainer.save_network(
            model, args.model_dir, {'features': list(FEATURES),
                                    'goal_conditioned': True}, args.steps))
    return history, model


def nce_batches(args):
    """(anchor, positive) frame pairs: consecutive frames of the records,
    or on synthetic frames a noisy copy of each."""
    h, w = args.image_height, args.image_width
    rng = np.random.RandomState(args.seed)
    if args.data_dir:
        from visual_foresight_torch.data.dataset_reader import (
            BaseVideoDataset)
        ds = BaseVideoDataset(args.data_dir, args.batch_size)
        for batch in ds.numpy_iterator(keys=('images',)):
            images = batch['images'].astype(np.float32) / 255.0
            T = images.shape[1]
            t = rng.randint(0, T - 1)
            yield images[:, t, args.camera], images[:, t + 1, args.camera]
    else:
        while True:
            base = rng.rand(args.batch_size, h, w, 3).astype(np.float32)
            noise = rng.randn(args.batch_size, h, w,
                              3).astype(np.float32) * 0.05
            yield base, np.clip(base + noise, 0, 1)


def nce_loss_fn(model, temp=NCE_TEMPERATURE):
    def loss_fn(anchors, positives):
        za, zp = model(anchors), model(positives)
        logits = za @ zp.T / temp
        labels = torch.arange(anchors.shape[0], device=logits.device)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {'loss': loss, 'acc': acc}
    return loss_fn


def train_nce(args, init=None):
    """InfoNCE over (frame_t, frame_{t+1}) positives within a batch;
    ``init`` (a flax tree) replaces the seeded initial weights.  Returns
    (history, model)."""
    model, device, tx = net_trainer.prepare(NCEEmbedding(), args, init)
    step_fn = net_trainer.make_step(tx, nce_loss_fn(model))
    history = net_trainer.run(args, step_fn, nce_batches(args), device)
    if args.model_dir:
        print('saved to', net_trainer.save_network(
            model, args.model_dir, {'features': list(FEATURES),
                                    'embed_dim': model.proj.out_features},
            args.steps))
    return history, model


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument('--mode', type=str, default='classifier',
                   choices=['classifier', 'nce'])
    p.add_argument('--data_dir', type=str, default='')
    p.add_argument('--model_dir', type=str, default='')
    p.add_argument('--steps', type=int, default=2000)
    p.add_argument('--batch_size', type=int, default=32)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--image_height', type=int, default=48)
    p.add_argument('--image_width', type=int, default=64)
    p.add_argument('--camera', type=int, default=0)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--log_every', type=int, default=50)
    p.add_argument('--label_mode', type=str, default='goal',
                   choices=['goal', 'lift'],
                   help="'goal' = goal-conditioned labels (success iff the "
                        "scene matches THIS goal); 'lift' = legacy "
                        'position-blind goal_reached labels')
    p.add_argument('--ambiguous_pixel_diff', type=float, default=0.01,
                   help='negatives whose frame/goal mean abs pixel gap is '
                        'below this are weight-0 (ambiguous)')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device ('cpu' runs on the CPU)")
    return p


if __name__ == '__main__':
    args = build_argparser().parse_args()
    if args.mode == 'classifier':
        train_classifier(args)
    else:
        train_nce(args)
