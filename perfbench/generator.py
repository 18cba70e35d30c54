"""The one general generator: weights, contexts, goals and draws of a cell,
made from ``--seed`` on the device in a few large calls.

Every seed makes the same sizes: the seed changes values, never the work.
Replan ``i`` of a run takes context ``i mod context_pool`` (frames, states
and executed actions, as a camera and the arm hand them over), the draws
``i mod draw_pool`` (the plan normals of every iteration and, for a model
with a latent, one latent a sample and iteration) and the goal of episode
``i // episode_replans``.  An episode's first replan starts from the
one-hot designated pixel; under ``predictor_propagation`` each later one
takes the best predicted distribution of the replan before it.

The weights are those that the configuration's architecture module
(``spec.arch``) names in its ``param_specs``.
"""

import numpy as np
import torch

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
# streams of the seed: one generator each, so that a traffic parameter
# never changes the weights
WEIGHTS, CONTEXTS, GOALS, DRAWS = range(4)


def generator(seed, stream, device):
    """A ``torch.Generator`` on ``device`` for one stream of ``seed`` (any
    whole number)."""
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])
    value = int(state.generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(value)


def make_weights(cfg, seed, device, arch):
    """name -> tensor in the type it is served in, for every weight that
    ``arch.param_specs(cfg)`` names: weights N(0, 1/fan_in), biases N(0,
    0.01/fan_in), LayerNorm scales 1 + N(0, 0.01) and offsets N(0, 0.01);
    one normal draw for each served type."""
    gen = generator(seed, WEIGHTS, device)
    specs = arch.param_specs(cfg)
    served = {'compute': DTYPES[cfg['dtype']], 'float32': torch.float32}
    out = {}
    for group, dtype in served.items():
        names = [n for n, s in specs.items() if s[3] == group]
        if not names:
            continue
        sizes = [int(np.prod(specs[n][0])) for n in names]
        scale, offset = [], []
        for n in names:
            _, role, fan_in, _ = specs[n]
            scale.append({'weight': fan_in ** -0.5,
                          'bias': 0.1 * fan_in ** -0.5}.get(role, 0.1))
            offset.append(1.0 if role == 'ln_weight' else 0.0)
        counts = torch.tensor(sizes, device=device)
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=torch.float32)
        flat = flat * torch.repeat_interleave(
            torch.tensor(scale, device=device), counts) + \
            torch.repeat_interleave(torch.tensor(offset, device=device),
                                    counts)
        flat = flat.to(dtype)
        for n, piece in zip(names, torch.split(flat, sizes)):
            out[n] = piece.view(specs[n][0])
    return out


class Workload:
    """The inputs of one run of a cell.

    Host arrays: ``images`` (context_pool, ncam, n_ctx, H, W, 3) in [0, 1),
    ``states`` (context_pool, n_ctx, sdim), ``actions`` (context_pool,
    n_ctx - 1, adim), ``onehot`` (episodes, ncam, n_ctx, H, W, P).  Device
    tensors: ``grids`` (episodes, ncam, P, H, W), ``noise`` (draw_pool,
    iterations, M, nactions * adim), ``latents`` (draw_pool, iterations, M,
    latent_dim) or None, ``vis_latents`` (draw_pool, min(n_vis, k_elite),
    latent_dim), the latents of a chunked replan's re-roll of its best
    plans, or None (unchunked, or no latent), and ``weights`` (of ``arch``,
    the configuration's architecture module).
    """

    def __init__(self, cfg, traffic, seed, device, arch):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        h, w = cfg['img_dims']
        ncam, p = traffic['ncam'], traffic['designated_pixels']
        n_ctx = cfg['context_frames']
        q, e = traffic['context_pool'], traffic['episodes']
        self.weights = make_weights(cfg, seed, device, arch)

        gen = generator(seed, CONTEXTS, device)
        std = torch.tensor(traffic['context_action_std'], device=device)
        if std.numel() != cfg['adim']:
            raise ValueError('context_action_std needs {} values'.format(
                cfg['adim']))
        self.images = torch.rand((q, ncam, n_ctx, h, w, 3), generator=gen,
                                 device=device).cpu().numpy()
        self.states = (traffic['state_std'] * torch.randn(
            (q, n_ctx, cfg['sdim']), generator=gen, device=device)
            ).cpu().numpy()
        self.actions = (std * torch.randn(
            (q, n_ctx - 1, cfg['adim']), generator=gen, device=device)
            ).cpu().numpy()

        gen = generator(seed, GOALS, device)
        margin = traffic['pixel_margin']
        lo = torch.tensor([margin, margin], device=device)
        hi = torch.tensor([h - margin, w - margin], device=device)
        u = torch.rand((2, e, ncam, p, 2), generator=gen, device=device)
        pix = (lo + u * (hi - lo)).floor()
        desig, goal = pix[0], pix[1]
        rows = torch.arange(h, dtype=torch.float32, device=device)
        cols = torch.arange(w, dtype=torch.float32, device=device)
        self.grids = torch.sqrt(
            (rows[:, None] - goal[..., 0, None, None]) ** 2 +
            (cols[None, :] - goal[..., 1, None, None]) ** 2)
        desig = desig.long().cpu().numpy()
        self.onehot = np.zeros((e, ncam, n_ctx, h, w, p), np.float32)
        for i in range(e):
            for c in range(ncam):
                for j in range(p):
                    r, col = desig[i, c, j]
                    self.onehot[i, c, :, r, col, j] = 1.0

        gen = generator(seed, DRAWS, device)
        d, iters, m = traffic['draw_pool'], traffic['iterations'], \
            traffic['num_samples']
        dims = traffic['nactions'] * cfg['adim']
        self.noise = torch.randn((d, iters, m, dims), generator=gen,
                                 device=device)
        self.latents = torch.randn(
            (d, iters, m, cfg['latent_dim']), generator=gen,
            device=device) if cfg['latent_dim'] else None
        # drawn after the others, so that a chunk moves no other draw
        vis = min(traffic['n_vis'], traffic['k_elite'])
        self.vis_latents = torch.randn(
            (d, vis, cfg['latent_dim']), generator=gen,
            device=device) if cfg['latent_dim'] and chunked(traffic) \
            else None

    def slot(self, i):
        """(context, draws, episode, position in the episode) of replan
        ``i``."""
        t = self.traffic
        return (i % t['context_pool'], i % t['draw_pool'],
                (i // t['episode_replans']) % t['episodes'],
                i % t['episode_replans'])

    def inputs(self, i, propagated=None):
        """Replan ``i``'s inputs as host arrays and device tensors.

        :param propagated: (ncam, n_ctx, H, W, P) distributions carried from
            the replan before (used only past an episode's first replan)
        """
        ctx, drw, epi, pos = self.slot(i)
        distribs = self.onehot[epi]
        if pos and self.traffic['predictor_propagation']:
            if propagated is None:
                raise ValueError('replan {} needs the distribution carried '
                                 'from the one before'.format(i))
            distribs = propagated
        return {'images': self.images[ctx], 'states': self.states[ctx],
                'actions': self.actions[ctx], 'distribs': distribs,
                'grids': self.grids[epi], 'noise': self.noise[drw],
                'latents': None if self.latents is None
                else self.latents[drw],
                'vis_latents': None if self.vis_latents is None
                else self.vis_latents[drw]}


def chunked(traffic):
    """Whether the planner rolls a replan's samples in chunks: a
    ``sample_chunk`` below the sample count that divides it, the rule of
    ``FusedCEMPlanner.replan``'s ``use_chunk`` term for term."""
    chunk, m = traffic.get('sample_chunk', 0), traffic['num_samples']
    return bool(chunk) and m > chunk and m % chunk == 0


def model_steps(cfg, traffic):
    """[(batch, steps)] of one replan: the context encode at batch 1, then
    every iteration's rollout of the samples over the horizon.  With a
    ``sample_chunk`` c below the M samples, an iteration rolls M / c chunks
    of c, and the last re-rolls its min(n_vis, k_elite) best plans."""
    horizon = traffic['nactions'] * traffic['repeat']
    m, rolls = traffic['num_samples'], traffic['iterations'] * horizon
    steps = [(1, cfg['context_frames'] - 1)]
    if not chunked(traffic):
        return steps + [(m, rolls)]
    chunk = traffic['sample_chunk']
    vis = min(traffic['n_vis'], traffic['k_elite'])
    return steps + [(chunk, rolls * m // chunk)] + \
        ([(vis, horizon)] if vis else [])
