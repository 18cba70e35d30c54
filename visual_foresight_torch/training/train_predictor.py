"""Video-predictor training (PyTorch).

Counterpart of ``visual_foresight_tpu/training/train_predictor.py``, with
its names and flags: scheduled-sampling teacher forcing (Finn et al. 2016),
L2 (+ L1) reconstruction and state losses, optax's chain of
``clip_by_global_norm(1.0)`` and AdamW under a warmup-cosine schedule (each
written out here, to optax's letter), and, with ``--stochastic``, the
SV2P posterior encoder with an annealed free-bits KL.

On the card every model step's warp-and-composite tail runs the forward
kernel of ``csrc/cdna_tail.cu`` and its gradient the backward kernel of
``csrc/cdna_tail_bwd.cu`` (``ops/cdna_tail.py``).  Parameters that the
model keeps in bf16 are updated through f32 copies held by the optimizer,
as JAX keeps f32 parameters and casts them at each use.

Checkpoints go under ``--model_dir`` in the JAX trainer's layout, orbax
step directories written with numpy alone (``prediction/checkpoints.py``):
``view0/step_<N>/`` (the flax tree that ``TorchPredictor.restore`` and
``TPUPredictor.restore`` read), the posterior under ``posterior/step_<N>/``
(stochastic runs) and optax's ``chain(clip_by_global_norm, adamw)`` state
under ``opt/step_<N>/``, with ``model_config.json`` beside them.  The
port's numpy files are written too: ``view0/params.npz`` with
``view0/checkpoint.json`` (the step), ``posterior/params.npz`` and
``opt/opt_state.npz`` (count, first and second moments per leaf).
``--resume`` reads the newest step directory where one exists, so it
resumes a run of either package, else the numpy files.

With ``--data_dir`` the batches come from collected GZIP-TFRecord shards
(``record_batches``): the native ingest engine by default, the Python reader
with ``--loader python``; the frames cross to the card as uint8 and are cast
there (``data/fused_ingest.py::device_ingest``).  A directory without
``manifest.pkl`` holds HDF5 trajectories, read by
``data/robonet_reader.py``.

With ``--n_devices`` > 1 the batch is split over a mesh of that many
devices of ``--device`` (``parallel/mesh.py``), as the JAX trainer shards
it: every replica computes its share's loss terms, the lead device sums
them, weighted by the shares' sizes, into the global batch's loss, and the
gradients come back summed onto the lead's parameters, which take the
step and are copied back to the replicas.  ``--device cuda`` takes the
first cards, ``--device cuda:0`` (or ``cpu``) repeats one device, whose
shares then run in turn.

CLI (``--device cpu`` runs the plain PyTorch path on the CPU)::

    python -m visual_foresight_torch.training.train_predictor \\
        --model_dir <ckpt dir> [--data_dir <records>] [--steps N] ...
"""

import argparse
import collections
import json
import math
import os
import time

import numpy as np
import torch

from visual_foresight_torch.data.fused_ingest import device_ingest
from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.models.convert import (flatten_flax,
                                                   load_flax_params,
                                                   params_from_flax,
                                                   params_to_flax,
                                                   unflatten_flax)
from visual_foresight_torch.models.latent import (PosteriorEncoder,
                                                  kl_to_standard_normal,
                                                  reparameterize)
from visual_foresight_torch.parallel.mesh import (make_mesh, replicate,
                                                  shard_batch)
from visual_foresight_torch.prediction import checkpoints
from visual_foresight_torch.prediction.predictor import PARAMS_FILE

OPT_FILE = 'opt_state.npz'
STEP_FILE = 'checkpoint.json'
# the trained modules and the checkpoint directory of each
MODULES = ('model', 'posterior')
_DIRS = {'model': 'view0', 'posterior': 'posterior'}


def scheduled_sampling_mask(generator, step, T, batch, n_context, k=900.0,
                            device=None):
    """Per-step probability of feeding ground truth; inverse-sigmoid decay
    (Finn et al.'s schedule): p = k / (k + exp(step / k)), in f32 on the
    host.  The uniforms come from ``generator`` (on ``device``)."""
    f32 = np.float32
    p = f32(k) / (f32(k) + np.exp(f32(step) / f32(k)))
    rand = torch.rand((batch, T), generator=generator, device=device)
    mask = (rand < float(p)).float()
    # context steps are always teacher-forced (step t consumes frame t)
    ctx = (torch.arange(T, device=rand.device) < n_context).float()
    return torch.maximum(mask, ctx[None])


def kl_beta_schedule(step, beta, anneal_start, anneal_end):
    """Linear KL-weight ramp 0 -> beta over [anneal_start, anneal_end], in
    f32 on the host (a numpy scalar)."""
    f32 = np.float32
    frac = (f32(step) - f32(anneal_start)) / \
        f32(max(anneal_end - anneal_start, 1.0))
    return f32(beta) * np.clip(frac, f32(0), f32(1))


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0):
    """optax's ``warmup_cosine_decay_schedule`` (exponent 1): a linear ramp
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then a
    cosine decay to ``end_value`` at ``decay_steps``; f32 arithmetic, as
    optax's.  Returns count -> learning rate (a numpy f32)."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError('the cosine decay needs decay_steps > warmup_steps')
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count):
        if count < warmup_steps:
            frac = f32(1) - f32(count) / f32(warmup_steps)
            return f32(init_value - peak_value) * frac + f32(peak_value)
        t = f32(min(count - warmup_steps, decay_steps - warmup_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(
            f32(np.pi) * t / f32(decay_steps - warmup_steps)))
        return f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha))
    return schedule


def training_schedule(args):
    """The trainer's learning-rate schedule, as the JAX trainer sets it."""
    return warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(200, args.steps // 10 + 1),
        decay_steps=max(args.steps, 2))


class ClippedAdamW:
    """``optax.chain(optax.clip_by_global_norm(max_norm),
    optax.adamw(schedule, b1, b2, eps, weight_decay=...))`` over named
    parameters.

    - the clip scales every gradient by ``max_norm / norm`` only where the
      global norm reaches ``max_norm``;
    - Adam's moments, bias-corrected with the count after the update;
      ``eps`` outside the square root;
    - weight decay on every leaf, added to the Adam direction;
    - the step is ``-schedule(count)`` at the count before the update, so
      update 0 of a schedule starting at 0 moves nothing.

    It keeps f32 copies of parameters held in another dtype and writes
    them back rounded after each update.  ``step()`` returns the global
    norm of the unclipped gradients (a 0-d tensor; no host sync), or None
    with ``max_norm`` None, which leaves the clip out.  :func:`adam` builds
    ``optax.adam(lr)`` from it.
    """

    def __init__(self, named_params, schedule, max_norm=1.0, b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=1e-5):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.schedule, self.max_norm = schedule, max_norm
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, \
            weight_decay
        # parameters kept in another dtype get an f32 copy, written back
        self.copied = [p.dtype != torch.float32 for p in self.params]
        self.master = [p.detach().float().clone() if c else p.detach()
                       for p, c in zip(self.params, self.copied)]
        self.mu = [torch.zeros_like(m) for m in self.master]
        self.nu = [torch.zeros_like(m) for m in self.master]
        self.count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        grads = [torch.zeros_like(m) if p.grad is None else p.grad.float()
                 for p, m in zip(self.params, self.master)]
        norm = None
        if self.max_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < self.max_norm
        # f32 scalars computed on the host: no copy to the device, no sync
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** (self.count + 1))
        bc2 = float(f32(1) - f32(self.b2) ** (self.count + 1))
        step_size = -float(self.schedule(self.count))
        for i, g in enumerate(grads):
            if norm is not None:
                g = torch.where(keep, g, g / norm * self.max_norm)
            self.mu[i] = (1 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
            update = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) +
                                           self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * self.master[i]
            self.master[i].add_(update * step_size)
            if self.copied[i]:
                self.params[i].copy_(self.master[i])
        self.count += 1
        return norm

    @torch.no_grad()
    def sync_master(self):
        """Refresh the f32 copies from the parameters (after a restore)."""
        for master, p, copied in zip(self.master, self.params, self.copied):
            if copied:
                master.copy_(p)

    def state(self):
        """{'count': int, 'mu': {name: tensor}, 'nu': {name: tensor}}."""
        return {'count': self.count,
                'mu': dict(zip(self.names, self.mu)),
                'nu': dict(zip(self.names, self.nu))}

    def load_state(self, state):
        """Restore :meth:`state`'s count and moments (tensors or arrays)."""
        self.count = int(state['count'])
        for key, moments in (('mu', self.mu), ('nu', self.nu)):
            for i, name in enumerate(self.names):
                moments[i].copy_(torch.as_tensor(state[key][name]))


def adam(named_params, lr):
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root) over named parameters: :class:`ClippedAdamW` with a constant
    rate, no clip and no weight decay."""
    rate = np.float32(lr)
    return ClippedAdamW(named_params, lambda count: rate, max_norm=None,
                        weight_decay=0.0)


def make_loss_fn(model, n_context, state_weight=1e-4, l1_weight=0.0,
                 ss_k=900.0, posterior=None, kl_beta=0.0, kl_anneal=(0, 1),
                 kl_free_nats=1.0):
    """Training loss.  With ``posterior`` set (a ``PosteriorEncoder``) the
    predictor trains as a variational model: the rollout conditions on the
    reparameterized posterior sample and the loss carries an annealed,
    free-bits KL(q(z|x) || N(0,1)).

    The returned ``loss_fn(batch, step, generator=None, gt_mask=None,
    eps=None)`` takes ``batch`` tensors on the model's device ('images' (B,
    T+1, H, W, C) float in [0, 1] or uint8, 'actions' (B, T, adim),
    'states' (B, T+1, sdim)) and the step (for the schedules); the
    scheduled-sampling mask and the latent noise are drawn from
    ``generator`` unless given (``gt_mask`` (B, T), ``eps`` (B,
    latent_dim)).  Returns (loss, metrics), 0-d tensors.

    Its parts, for a batch split over devices: ``loss_fn.draws(batch, step,
    generator, gt_mask, eps)`` makes the whole batch's draws as
    ``loss_fn`` makes them; ``loss_fn.terms(model, posterior, batch,
    gt_mask, eps)`` the batch means of one share (linear in the samples);
    ``loss_fn.combine(terms, step)`` the loss and metrics of the terms."""
    def draws(batch, step, generator, gt_mask=None, eps=None):
        images = batch['images']
        b, tp1 = images.shape[:2]
        if gt_mask is None:
            gt_mask = scheduled_sampling_mask(generator, step, tp1 - 1, b,
                                              n_context, k=ss_k,
                                              device=images.device)
        if eps is None and model.latent_dim and generator is not None:
            eps = torch.randn((b, model.latent_dim), generator=generator,
                              device=images.device)
        return gt_mask, eps

    def terms(model, posterior, batch, gt_mask, eps):
        images = batch['images']
        if images.dtype == torch.uint8:
            images = device_ingest(images, torch.float32)
        actions, states = batch['actions'], batch['states']
        kl = None
        if posterior is not None:
            mu, log_var = posterior(images)
            z = reparameterize(None, mu, log_var, eps)
            out = model(images, actions, states, gt_mask=gt_mask, latent=z)
            kl = kl_to_standard_normal(mu, log_var)
        else:
            out = model(images, actions, states, gt_mask=gt_mask, latent=eps)
        pred = out['gen_images']          # (B, T, H, W, C) predicts 1..T
        target = images[:, 1:]
        result = {'img_l2': torch.mean((pred - target).square()),
                  'state_l2': torch.mean(
                      (out['gen_states'] - states[:, 1:]).square())}
        if l1_weight:
            result['l1'] = torch.mean((pred - target).abs())
        if kl is not None:
            result['kl'] = kl
        return result

    def combine(t, step):
        l2, state_l2 = t['img_l2'], t['state_l2']
        loss = l2
        if l1_weight:
            loss = loss + l1_weight * t['l1']
        loss = loss + state_weight * state_l2
        metrics = {'loss': loss, 'img_l2': l2, 'state_l2': state_l2,
                   'psnr': -10.0 * torch.log10(torch.clamp(l2, min=1e-10))}
        if 'kl' in t:
            # free bits: KL below the floor costs nothing, so early
            # reconstruction learning cannot collapse the posterior
            kl = t['kl']
            beta = float(kl_beta_schedule(step, kl_beta, *kl_anneal))
            loss = loss + beta * torch.clamp(kl - kl_free_nats, min=0.0)
            metrics.update({'loss': loss, 'kl': kl,
                            'kl_beta': torch.full_like(kl, beta)})
        return loss, metrics

    def loss_fn(batch, step, generator=None, gt_mask=None, eps=None):
        gt_mask, eps = draws(batch, step, generator, gt_mask, eps)
        return combine(terms(model, posterior, batch, gt_mask, eps), step)
    loss_fn.draws, loss_fn.terms, loss_fn.combine = draws, terms, combine
    return loss_fn


def make_train_step(model, tx, n_context, mesh=None, **loss_kwargs):
    """``train_step(batch, step, generator=None, gt_mask=None, eps=None)``:
    one update of ``tx`` (a :class:`ClippedAdamW` over the model's and the
    posterior's parameters); returns the metrics, ``grad_norm`` the global
    norm of the unclipped gradients.

    With a ``mesh`` (``parallel.mesh.Mesh``, the model on its lead device)
    the batch, given whole on the lead, is split over the mesh after the
    draws are made for all of it; the loss is the shares' terms weighted by
    their sizes (the global batch's mean, as JAX differentiates it), the
    gradients are summed onto the lead's parameters, and after the step the
    replicas on other devices take the lead's parameters."""
    loss_fn = make_loss_fn(model, n_context, **loss_kwargs)
    posterior = loss_kwargs.get('posterior')
    replicas = []     # per device of the mesh: (model, posterior)
    copies = []       # the replicas that are copies, each once

    def sharded_loss(batch, step, generator, gt_mask, eps):
        gt_mask, eps = loss_fn.draws(batch, step, generator, gt_mask, eps)
        if not replicas:
            # built at the first step, after any restore into the lead's
            replicas.extend(zip(replicate(mesh, model), replicate(
                mesh, posterior) if posterior is not None else
                [None] * mesh.size))
            copies.extend({id(m): (m, post) for m, post in replicas
                           if m is not model}.values())
        shares = shard_batch(mesh, dict(batch, gt_mask=gt_mask, eps=eps))
        total = {}
        for (m, post), share in zip(replicas, shares):
            weight = share['gt_mask'].shape[0] / gt_mask.shape[0]
            part = loss_fn.terms(m, post, share, share.pop('gt_mask'),
                                 share.pop('eps'))
            for k, v in part.items():
                v = weight * v.to(mesh.lead)
                total[k] = v if k not in total else total[k] + v
        return loss_fn.combine(total, step)

    def train_step(batch, step, generator=None, gt_mask=None, eps=None):
        tx.zero_grad()
        if mesh is None:
            loss, metrics = loss_fn(batch, step, generator, gt_mask, eps)
        else:
            for m, post in copies:
                for p in _replica_params(m, post):
                    p.grad = None
            loss, metrics = sharded_loss(batch, step, generator, gt_mask,
                                         eps)
        loss.backward()
        if mesh is not None:
            _sum_grads(copies, tx.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics['grad_norm'] = tx.step()
        if mesh is not None:
            _copy_params(tx.params, copies)
        return metrics
    return train_step


def _replica_params(model, posterior):
    return [p for _, p in _named_params(model, posterior)]


@torch.no_grad()
def _sum_grads(replicas, params):
    """Add each replica's gradients into the lead's ``params`` (in the
    order of ``_named_params``)."""
    for m, post in replicas:
        for lead, p in zip(params, _replica_params(m, post)):
            if p.grad is None:
                continue
            g = p.grad.to(lead.device)
            lead.grad = g if lead.grad is None else lead.grad + g


@torch.no_grad()
def _copy_params(params, replicas):
    """Copy the lead's ``params`` into every replica."""
    for m, post in replicas:
        for lead, p in zip(params, _replica_params(m, post)):
            p.copy_(lead)


def build_model(args):
    return CDNAPredictor(
        (args.image_height, args.image_width),
        n_context=args.context_frames, num_masks=args.num_masks,
        kernel_size=args.cdna_kernel_size, sna=not args.no_sna,
        latent_dim=args.latent_dim, num_distribs=0, sdim=args.sdim,
        adim=args.adim, lstm_kernel=args.lstm_kernel,
        separable_lstm=args.separable_lstm, std_factor=args.std_factor,
        enc_features=tuple(args.enc_features),
        dtype=torch.bfloat16 if args.bf16 else torch.float32)


def build_posterior(args):
    return PosteriorEncoder(
        args.latent_dim, dtype=torch.bfloat16 if args.bf16 else torch.float32)


@torch.no_grad()
def init_params(model, seed=0):
    """Flax's default initialization of every parameter of ``model``,
    drawn from a generator seeded with ``seed``: kernels lecun-normal (a
    normal truncated at two deviations, std sqrt(1 / fan_in) / 0.8796),
    biases zero, LayerNorm scales one.  The draws differ from JAX's.
    Returns the module's ``state_dict``."""
    gen = torch.Generator().manual_seed(int(seed))
    lo, hi = [0.5 * (1 + math.erf(v / math.sqrt(2))) for v in (-2.0, 2.0)]
    for name, p in model.named_parameters():
        if name.endswith('bias'):
            p.zero_()
        elif p.dim() == 1:                  # LayerNorm scale
            p.fill_(1.0)
        else:
            fan_in = int(np.prod(p.shape[1:]))
            u = torch.rand(p.shape, generator=gen, dtype=torch.float64) * \
                (hi - lo) + lo
            x = math.sqrt(2) * torch.erfinv(2 * u - 1)
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            p.copy_(torch.clamp(x, -2, 2) * std)
    return model.state_dict()


def synthetic_batches(args, seed=0):
    """Deterministic synthetic data for smoke training (moving square); the
    same numpy draws as the JAX trainer's, so the same batches."""
    rng = np.random.RandomState(seed)
    h, w = args.image_height, args.image_width
    T = args.sequence_length
    while True:
        imgs = np.zeros((args.batch_size, T, h, w, 3), np.float32)
        actions = rng.uniform(-1, 1, (args.batch_size, T - 1,
                                      args.adim)).astype(np.float32) * 0.5
        states = np.zeros((args.batch_size, T, args.sdim), np.float32)
        for b in range(args.batch_size):
            r, c = rng.randint(2, h - 6), rng.randint(2, w - 6)
            color = rng.rand(3)
            for t in range(T):
                imgs[b, t] = 0.1
                imgs[b, t, r:r + 4, c:c + 4] = color
                states[b, t, :2] = [r / h, c / w]
                if t < T - 1:
                    r = int(np.clip(r + round(actions[b, t, 0] * 4), 0, h - 5))
                    c = int(np.clip(c + round(actions[b, t, 1 % args.adim] * 4),
                                    0, w - 5))
        yield {'images': imgs, 'actions': actions, 'states': states}


def record_batches(args):
    """Batches from collected TFRecords or RoboNet-format HDF5: ``{'images':
    uint8 (B, T, H, W, 3), 'actions': f32 (B, T-1, adim), 'states': f32 (B,
    T, sdim)}`` of camera ``--camera``, cut to ``--sequence_length``.
    TFRecord shards (a directory with ``manifest.pkl``) go through
    ``fused_ingest.make_loader``: the native engine, or the threaded Python
    reader with ``--loader python`` or where the engine cannot be built.
    Any other directory holds HDF5 trajectories (RoboNet traj-per-file or
    the bucketed ``HDF5Saver`` layout) and goes through
    ``data/robonet_reader.RoboNetTrajReader``, which raises
    ``FileNotFoundError`` where it finds none."""
    if not os.path.isfile(os.path.join(args.data_dir, 'manifest.pkl')):
        from visual_foresight_torch.data.robonet_reader import (
            RoboNetTrajReader)
        loader = RoboNetTrajReader(args.data_dir, args.batch_size,
                                   sequence_length=args.sequence_length,
                                   seed=args.seed)
        return _camera_batches(loader, args)
    from visual_foresight_torch.data import fused_ingest
    loader = fused_ingest.make_loader(
        args.data_dir, args.batch_size, prefer_native=args.loader != 'python',
        threads=args.loader_threads, seed=args.seed)
    return _camera_batches(loader, args)


def _camera_batches(loader, args):
    for batch in loader:
        images = batch['images']          # (B, T, ncam, H, W, 3) uint8
        cam = min(args.camera, images.shape[2] - 1)
        yield {
            'images': np.ascontiguousarray(
                images[:, :args.sequence_length, cam]),
            'actions': batch['actions'][:, :args.sequence_length - 1]
            .astype(np.float32),
            'states': batch['state'][:, :args.sequence_length]
            .astype(np.float32),
        }


def model_config_dict(args):
    """The architecture hparams a serving-side predictor needs to rebuild
    this exact model, written next to the checkpoints."""
    return {
        'context_frames': args.context_frames,
        'num_masks': args.num_masks,
        'kernel_size': args.cdna_kernel_size,
        'sna': not args.no_sna,
        'dna': False,
        'latent_dim': args.latent_dim,
        'lstm_kernel': args.lstm_kernel,
        'separable_lstm': args.separable_lstm,
        'std_factor': args.std_factor,
        'enc_features': list(args.enc_features),
        'dtype': 'bfloat16' if args.bf16 else 'float32',
        'adim': args.adim,
        'sdim': args.sdim,
        'sequence_length': args.sequence_length,
        'img_dims': [args.image_height, args.image_width],
        # provenance only: planning samples the latent from the prior, so
        # serving needs no posterior parameters
        'stochastic': bool(args.stochastic),
    }


Trainer = collections.namedtuple(
    'Trainer', 'model posterior tx train_step generator device mesh')


def make_trainer(args, device=None):
    """Model (and posterior) seeded as the JAX trainer seeds them (model 0,
    posterior 1; other draws), the optimizer and the train step, on the
    lead device of the mesh of ``--n_devices`` devices of ``device``
    (default ``args.device``), the batch split over the mesh where it has
    more than one.  ``train`` runs on this."""
    # -1 (or 0): every device, one where the device is named
    mesh = make_mesh(args.n_devices if args.n_devices > 0 else None,
                     device=device or args.device)
    device = mesh.lead
    model = build_model(args)
    init_params(model, seed=0)
    model.to(device)
    posterior = None
    if args.stochastic:
        if args.latent_dim <= 0:
            raise ValueError('--stochastic requires --latent_dim > 0')
        posterior = build_posterior(args)
        init_params(posterior, seed=1)
        posterior.to(device)
    tx = ClippedAdamW(_named_params(model, posterior),
                      training_schedule(args), max_norm=1.0,
                      weight_decay=1e-5)
    kl_anneal = (float(args.kl_anneal_start if args.kl_anneal_start >= 0
                       else args.steps // 4),
                 float(args.kl_anneal_end if args.kl_anneal_end >= 0
                       else args.steps // 2))
    step = make_train_step(model, tx, args.context_frames,
                           state_weight=args.state_weight,
                           l1_weight=args.l1_weight, ss_k=args.ss_k,
                           posterior=posterior, kl_beta=args.kl_beta,
                           kl_anneal=kl_anneal,
                           kl_free_nats=args.kl_free_nats,
                           mesh=mesh if mesh.size > 1 else None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return Trainer(model, posterior, tx, step, gen, device, mesh)


def _named_params(model, posterior=None):
    """(name, parameter) over the model and the posterior; a name is
    '<module>/<state_dict key>'."""
    modules = {'model': model, 'posterior': posterior}
    return [('{}/{}'.format(key, n), p) for key in MODULES
            if modules[key] is not None
            for n, p in modules[key].named_parameters()]


def to_device(batch, device):
    """A numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def train(args):
    """Train for ``args.steps`` steps on the records in ``--data_dir`` or
    on synthetic batches (resuming from ``--model_dir`` with ``--resume``).
    Returns (history, trainer): the logged metrics and the
    :class:`Trainer` it ran."""
    batches = record_batches(args) if args.data_dir else \
        synthetic_batches(args)
    trainer = make_trainer(args)
    model, posterior, tx = trainer.model, trainer.posterior, trainer.tx
    start_step = 0

    if args.resume and args.model_dir:
        start_step = _restore(args, model, posterior, tx)

    if args.model_dir:
        os.makedirs(args.model_dir, exist_ok=True)
        with open(os.path.join(args.model_dir, 'model_config.json'),
                  'w') as f:
            json.dump(model_config_dict(args), f, indent=1)

    n_params = sum(p.numel() for _, p in _named_params(model, posterior))
    print('model params:', n_params)
    print('mesh devices:', ', '.join(str(d) for d in trainer.mesh.devices))

    t0 = time.time()
    history = []
    for step in range(start_step, args.steps):
        batch = to_device(next(batches), trainer.device)
        metrics = trainer.train_step(batch, step, trainer.generator)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m['step'] = step
            m['sec'] = round(time.time() - t0, 1)
            history.append(m)
            print(json.dumps(m), flush=True)
        if args.model_dir and args.ckpt_every and \
                step > 0 and step % args.ckpt_every == 0:
            save_all(args.model_dir, model, posterior, tx, step)

    if args.model_dir:
        path = save_all(args.model_dir, model, posterior, tx, args.steps)
        print('saved final checkpoint to', path)
    return history, trainer


def _save_npz(path, flat):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + '.tmp.npz'
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_all(model_dir, model, posterior, tx, step):
    """Write the serving checkpoint, the posterior (stochastic runs) and
    the optimizer state at ``step``: as the JAX trainer's ``_save_all``
    does, orbax step directories (``view0/step_<N>``,
    ``posterior/step_<N>``, ``opt/step_<N>`` holding optax's chain state),
    and the port's numpy files (``view0/params.npz`` and its step, the
    posterior's, ``opt/opt_state.npz`` with the moments in the flax layout
    of their parameters).  Returns the ``view0`` path."""
    modules = {'model': model, 'posterior': posterior}
    state = tx.state()
    opt = {'count': np.asarray(state['count'], np.int64),
           'step': np.asarray(step, np.int64)}
    moments = {'mu': {}, 'nu': {}}
    for key in MODULES:
        if modules[key] is None:
            continue
        tree = params_to_flax(modules[key].state_dict())
        checkpoints.save_params(tree, os.path.join(model_dir, _DIRS[key]),
                                step)
        _save_npz(os.path.join(model_dir, _DIRS[key], PARAMS_FILE),
                  flatten_flax(tree))
        for moment in ('mu', 'nu'):
            own = {n.split('/', 1)[1]: v for n, v in state[moment].items()
                   if n.startswith(key + '/')}
            moments[moment][key] = params_to_flax(own)
            for leaf, value in flatten_flax(moments[moment][key]).items():
                opt['{}/{}/{}'.format(key, moment, leaf)] = value
    checkpoints.save_params(_optax_state(moments, state['count'],
                                         posterior is not None),
                            os.path.join(model_dir, 'opt'), step)
    _save_npz(os.path.join(model_dir, 'opt', OPT_FILE), opt)
    view = os.path.join(model_dir, _DIRS['model'])
    with open(os.path.join(view, STEP_FILE), 'w') as f:
        json.dump({'step': int(step)}, f)
    return view


def _optax_state(moments, count, stochastic):
    """The tree of ``optax.chain(clip_by_global_norm, adamw(schedule))``'s
    state as orbax keeps it: the clip's and the decay's empty states as
    None, Adam's count and moments, the schedule's count.  The moments
    mirror the parameters: the model's flax tree, or {'model', 'posterior'}
    of a stochastic run."""
    count = np.asarray(count, np.int32)
    tree = {m: moments[m] if stochastic else moments[m]['model']
            for m in ('mu', 'nu')}
    return [None, [{'count': count, 'mu': tree['mu'], 'nu': tree['nu']},
                   None, {'count': count}]]


def _read_flat(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _restore(args, model, posterior, tx):
    """Restore the checkpoint in ``args.model_dir``: parameters, and the
    optimizer state where one was saved at the same step; without one, Adam
    starts afresh and the schedule is fast-forwarded to the step.  The
    newest ``view0/step_<N>`` is read where one exists, as the JAX
    trainer's resume does (the posterior's and the optimizer's at the same
    step), else the numpy files.  Returns the step to continue from (0
    when there is no checkpoint)."""
    view = os.path.join(args.model_dir, _DIRS['model'])
    modules = {'model': model, 'posterior': posterior}
    latest = checkpoints.latest_checkpoint(view)
    if latest is not None:
        start_step = int(latest.rsplit('_', 1)[1])
        for key in MODULES:
            if modules[key] is not None:
                load_flax_params(modules[key], checkpoints.restore_params(
                    os.path.join(args.model_dir, _DIRS[key]),
                    step=start_step))
        try:
            tree = checkpoints.restore_params(
                os.path.join(args.model_dir, 'opt'), step=start_step)
        except FileNotFoundError:
            state = None
        else:
            state = _state_from_optax(tree, modules)
        source = latest
    elif os.path.isfile(os.path.join(view, STEP_FILE)):
        with open(os.path.join(view, STEP_FILE)) as f:
            start_step = int(json.load(f)['step'])
        for key in MODULES:
            if modules[key] is not None:
                load_flax_params(modules[key], unflatten_flax(_read_flat(
                    os.path.join(args.model_dir, _DIRS[key], PARAMS_FILE))))
        opt_path = os.path.join(args.model_dir, 'opt', OPT_FILE)
        opt = _read_flat(opt_path) if os.path.isfile(opt_path) else None
        state = None
        if opt is not None and int(opt['step']) == start_step:
            state = {'count': int(opt['count']), 'mu': {}, 'nu': {}}
            for key in MODULES:
                if modules[key] is None:
                    continue
                for moment in ('mu', 'nu'):
                    prefix = '{}/{}/'.format(key, moment)
                    tree = unflatten_flax({k[len(prefix):]: v for k, v in
                                           opt.items()
                                           if k.startswith(prefix)})
                    for n, v in params_from_flax(tree).items():
                        state[moment]['{}/{}'.format(key, n)] = v
        source = view
    else:
        return 0
    tx.sync_master()
    if state is not None:
        tx.load_state(state)
        print('resumed opt state at step {}'.format(start_step))
    else:
        # a checkpoint without optimizer state: keep Adam fresh but
        # fast-forward the schedule so the learning rate is continuous
        tx.count = start_step
        print('WARNING: no saved opt state; Adam moments reset, schedule '
              'fast-forwarded to step {}'.format(start_step))
    print('resumed from {} (step {})'.format(source, start_step))
    return start_step


def _state_from_optax(tree, modules):
    """``ClippedAdamW.load_state``'s dict from an optax chain state read by
    ``checkpoints.restore_params`` (the layout of :func:`_optax_state`)."""
    try:
        adam = tree[1][0]
        count, mu, nu = adam['count'], adam['mu'], adam['nu']
    except (IndexError, KeyError, TypeError):
        raise ValueError('the optimizer checkpoint is not optax\'s chain of '
                         'clip_by_global_norm and adamw')
    state = {'count': int(count), 'mu': {}, 'nu': {}}
    stochastic = modules['posterior'] is not None
    for moment, tree_m in (('mu', mu), ('nu', nu)):
        for key in MODULES:
            if modules[key] is None:
                continue
            sub = tree_m[key] if stochastic else tree_m
            for n, v in params_from_flax(sub).items():
                state[moment]['{}/{}'.format(key, n)] = v
    return state


def build_argparser():
    p = argparse.ArgumentParser(description='train the CDNA video predictor')
    p.add_argument('--data_dir', type=str, default='',
                   help='TFRecords dir (default: synthetic data)')
    p.add_argument('--model_dir', type=str, default='')
    p.add_argument('--steps', type=int, default=1000)
    p.add_argument('--batch_size', type=int, default=16)
    p.add_argument('--lr', type=float, default=1e-3)
    p.add_argument('--sequence_length', type=int, default=15)
    p.add_argument('--context_frames', type=int, default=2)
    p.add_argument('--image_height', type=int, default=48)
    p.add_argument('--image_width', type=int, default=64)
    p.add_argument('--adim', type=int, default=3)
    p.add_argument('--sdim', type=int, default=3)
    p.add_argument('--num_masks', type=int, default=10)
    p.add_argument('--cdna_kernel_size', type=int, default=5)
    p.add_argument('--latent_dim', type=int, default=0)
    p.add_argument('--stochastic', action='store_true', default=False,
                   help='variational training (SV2P semantics): posterior '
                        'encoder over the trajectory + annealed KL')
    p.add_argument('--kl_beta', type=float, default=1e-4,
                   help='final KL weight')
    p.add_argument('--kl_anneal_start', type=int, default=-1,
                   help='step where the KL ramp starts (-1: steps/4)')
    p.add_argument('--kl_anneal_end', type=int, default=-1,
                   help='step where beta reaches kl_beta (-1: steps/2)')
    p.add_argument('--kl_free_nats', type=float, default=1.0,
                   help='free-bits floor: KL below this costs nothing')
    p.add_argument('--lstm_kernel', type=int, default=5)
    p.add_argument('--separable_lstm', action='store_true', default=True)
    p.add_argument('--dense_lstm', dest='separable_lstm',
                   action='store_false',
                   help='dense conv-LSTM gates (strict Finn-CDNA parity)')
    p.add_argument('--no_sna', action='store_true')
    p.add_argument('--std_factor', type=int, default=0,
                   help='>0: space-to-depth backbone at (H/r, W/r); the '
                        'serving flagship uses 4')
    p.add_argument('--enc_features', type=int, nargs=3, default=(32, 64, 128),
                   help='feature widths; the r=4 flagship uses 128 256 256')
    p.add_argument('--bf16', action='store_true')
    p.add_argument('--state_weight', type=float, default=1e-4)
    p.add_argument('--ss_k', type=float, default=900.0,
                   help='scheduled-sampling decay constant; p(gt) = '
                        'k/(k+exp(step/k))')
    p.add_argument('--l1_weight', type=float, default=0.0)
    p.add_argument('--camera', type=int, default=0)
    p.add_argument('--loader', choices=('fused', 'python'), default='fused',
                   help='record reader with --data_dir: the native '
                        'engine (fused) or the threaded Python reader')
    p.add_argument('--loader_threads', type=int, default=2)
    p.add_argument('--n_devices', type=int, default=-1,
                   help='split the batch over this many devices of '
                        '--device (-1: every one; cuda:0 or cpu repeat '
                        'one)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--log_every', type=int, default=20)
    p.add_argument('--ckpt_every', type=int, default=0)
    p.add_argument('--resume', action='store_true', default=False,
                   help='resume from the latest checkpoint in model_dir')
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device ('cpu' runs the plain PyTorch path)")
    return p


if __name__ == '__main__':
    train(build_argparser().parse_args())
