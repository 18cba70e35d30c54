"""CEM replanning on the device (PyTorch).

Counterpart of ``visual_foresight_tpu/planners/cem.py::FusedCEMPlanner``:
encode the context once at batch 1 and broadcast the carry over the samples
(over one chunk of them, or over each device's share of a mesh), then for
each iteration sample plans, roll them out, score them, take the elites and
refit.  The plans come from the Gaussian sampler (with its options), from
MPPI's AR(1)-correlated noise around a soft elite-weighted mean, or from the
folding prior; the autograsp latch and the AutograspEpsilon gripper derive a
grip command on top of Gaussian plans.  The replan makes no host round trip
until the caller reads a result.
"""

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.models.cdna import broadcast_carry
from visual_foresight_torch.parallel.mesh import (gather, replicate,
                                                  shard_bounds)
from visual_foresight_torch.planners import costs as cost_lib
from visual_foresight_torch.planners.gaussian import (
    ActionSpec, ag_epsilon_transform, autograsp_gripper_latch,
    autograsp_gripper_resample, fit_elites, folding_sample, sample_actions)

# the JAX planner's other arguments, at the values that leave them off
_UNPORTED_DEFAULTS = {'donate_dist': True}


def _lowest(scores, k):
    """The ``k`` lowest scores and their indices, best first; among equal
    scores the lowest index comes first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among equals)."""
    idx = torch.sort(scores, stable=True).indices[:k]
    return scores[idx], idx


def _first_rows(carry, n):
    """The first ``n`` samples of a broadcast carry."""
    if isinstance(carry, tuple):
        return tuple(_first_rows(t, n) for t in carry)
    return None if carry is None else carry[:n]


class FusedCEMPlanner:
    """Runs CEM replans through per-camera predictor modules.

    :param spec: ActionSpec (static sampling description)
    :param num_samples: M candidates per CEM iteration
    :param iterations: CEM iterations
    :param k_elite: elite count for the refit
    :param finalweight: last-step weight in the pixel cost
    :param rejection_rounds: bounded rejection-resample rounds (0 = off)
    :param action_bound: clip xy/theta after sampling
    :param cost_fn: optional override mapping (gen_images, gen_distribs,
        cost_ctx) -> (M,) scores; defaults to expected pixel distance with
        cost_ctx = the (ncam, P, H, W) goal distance grids
    :param n_vis: how many elite rollouts to return for visualization
    :param smooth_cov: average each refit covariance with the previous
        iteration's (the first with the covariance passed in)
    :param add_zero_action: candidate 0 is always the null plan
    :param mppi: MPPI mode (CorrelatedNoiseSampler): dict with kappa,
        beta_0, beta_1, refit_cov, mean_bias, per_dim_std.  Plans are
        AR(1)-filtered noise around a mean plan, the update is the
        elites' soft ``exp(kappa * (r - max r))``-weighted mean
    :param autograsp: autograsp mode (AutograspSampler): dict with z_thresh,
        norm_factor, close_cmd, open_cmd, reopen, deviation_prob, no_refit,
        z_index, state_z_index.  The spec covers the base dims; the grip
        command is derived from the cumulative z and appended as the last
        plan dim, and left out of the refit
    :param stochastic_k: every unique plan appears this many times in the
        batch, each copy with its own latent draw
    :param discrete_dims: plan dims floored and clipped into {0..4}
    :param ag_epsilon: AutograspEpsilon mode: dict with z_dim, grip_dim,
        z_norm, zthresh, epsilon, base_frac, base_frac_reduce, repeat,
        state_z_index.  The first ``max(int(M * base_frac *
        base_frac_reduce ** itr), 1)`` plans of iteration ``itr`` get the
        cumulative-z gripper with epsilon flips
    :param folding: folding mode (FoldingCEMSampler): dict with split_frac,
        max_shift.  The structured pick-fold-place prior mixed with
        Gaussian plans; 4 base dims
    :param sample_chunk: roll the samples in chunks of this size (0 = all at
        once); scores, elites and refit are the same, the final iteration's
        visualisation rollouts are re-rolled for the ``n_vis`` elites alone
    :param stochastic_penalty: with ``stochastic_k`` > 1, select elites among
        the unique plans on mean + penalty * std of their copies' scores
    :param mesh: a ``parallel.mesh.Mesh``: the samples are split into one
        share a device (``num_samples`` must divide over it; a warm start's
        smaller count that does not is split unevenly, as XLA pads it) and
        each share is rolled out and scored on its device; the draws, the
        elites, the refit and the videos stay on the lead device, so the
        replan is draw for draw the unsharded one.  Not with
        ``sample_chunk``.  A custom ``cost_fn`` runs on each share's device
        with its ``cost_ctx`` copied there
    :param device: where the replan runs ('cuda' unless the caller asks for
        the CPU); with a mesh, its lead device

    With a latent model (``latent_dim`` > 0) each rollout draws one latent
    per sample, shared by all cameras: one draw per iteration, one per chunk
    in chunked mode, and one more for the chunked visualisation re-roll.

    The JAX planner's ``donate_dist`` (``_UNPORTED_DEFAULTS``) is not
    ported: any value but ``True`` raises ``NotImplementedError``.
    """

    def __init__(self, spec: ActionSpec, num_samples: int,
                 iterations: int = 3, k_elite: int = 10,
                 finalweight: float = 10.0, rejection_rounds: int = 0,
                 action_bound: bool = True, only_first_view: bool = False,
                 cost_fn=None, n_vis: int = 10, blockdiag_refit: bool = False,
                 smooth_cov: bool = False, add_zero_action: bool = False,
                 mppi=None, autograsp=None, stochastic_k: int = 1,
                 discrete_dims=(), ag_epsilon=None, folding=None,
                 sample_chunk: int = 0, stochastic_penalty: float = 0.0,
                 mesh=None, device='cuda', **modes):
        unknown = sorted(set(modes) - set(_UNPORTED_DEFAULTS))
        if unknown:
            raise TypeError('unexpected arguments {}'.format(unknown))
        unported = sorted(k for k, v in modes.items()
                          if v != _UNPORTED_DEFAULTS[k])
        if unported:
            raise NotImplementedError('planner modes not ported: {}'.format(
                unported))
        if k_elite > num_samples:
            raise ValueError('k_elite must not exceed num_samples')
        self._spec = spec
        self._M = num_samples
        self._iterations = iterations
        self._K = k_elite
        self._finalweight = finalweight
        self._rej = int(rejection_rounds)
        self._bound = action_bound
        self._ofv = only_first_view
        self._cost_fn = cost_fn
        self._n_vis = min(n_vis, num_samples)
        self._blockdiag = blockdiag_refit
        self._smooth_cov = smooth_cov
        self._add_zero = add_zero_action
        self._mppi = dict(mppi) if mppi else None
        self._ag = dict(autograsp) if autograsp else None
        self._ag_eps = dict(ag_epsilon) if ag_epsilon else None
        self._folding = dict(folding) if folding else None
        if self._ag and self._mppi:
            raise ValueError('the autograsp latch composes with Gaussian '
                             'sampling, not MPPI')
        if self._ag_eps and (self._ag or self._mppi):
            raise ValueError('ag_epsilon is its own sampling mode')
        if self._folding and (self._ag or self._ag_eps or self._mppi):
            raise ValueError('folding is its own sampling mode')
        if self._folding and spec.adim != 4:
            raise ValueError('the folding prior needs 4 base action dims')
        self._mesh = mesh
        if mesh is not None and num_samples % mesh.size:
            raise ValueError('num_samples must divide over the mesh\'s {} '
                             'devices'.format(mesh.size))
        if mesh is not None and sample_chunk:
            raise ValueError('sample_chunk and a mesh are separate regimes '
                             '(shard large sample counts over devices)')
        self.device = mesh.lead if mesh is not None else \
            resolve_device(device)
        if self._mppi:
            # made once: a tensor made from host data in the replan would
            # wait for the device before each iteration
            self._mppi_scale = torch.tensor(self._mppi['per_dim_std'],
                                            dtype=torch.float32,
                                            device=self.device)
            self._mppi_bias = torch.tensor(
                self._mppi.get('mean_bias') or [0.0] * spec.adim,
                dtype=torch.float32, device=self.device)
        self._stoch_k = int(stochastic_k)
        if self._stoch_k < 1 or num_samples % self._stoch_k:
            raise ValueError('num_samples must be a multiple of '
                             'stochastic_k')
        self._stoch_penalty = float(stochastic_penalty)
        if self._stoch_penalty and self._stoch_k < 2:
            raise ValueError('stochastic_penalty needs stochastic_k > 1 '
                             'copies')
        self._discrete = tuple(int(d) for d in discrete_dims)
        self._chunk = int(sample_chunk)
        if self._chunk:
            if num_samples % self._chunk:
                raise ValueError('num_samples must be a multiple of '
                                 'sample_chunk')
            if self._chunk < max(k_elite, self._n_vis):
                raise ValueError('sample_chunk must cover k_elite and n_vis')

    @property
    def spec(self):
        return self._spec

    @property
    def is_mppi(self):
        return self._mppi is not None

    @staticmethod
    def _encode_contexts(models, images, states, distribs, context_actions):
        """Consume the context once per camera at batch 1: the carries to
        broadcast across the samples."""
        return [model.encode_context(images[c][None], context_actions[None],
                                     states[None], distribs[c][None])
                for c, model in enumerate(models)]

    def _shards(self, models, carries1, cost_ctx, M, rows):
        """The rollout's shares: (lo, hi, device, models, carries, cost
        context) for each device with samples, the carries broadcast to
        ``rows`` samples (the chunk) or to the share's ``hi - lo``."""
        if self._mesh is None:
            return [(0, M, self.device, models,
                     [broadcast_carry(c, rows or M) for c in carries1],
                     cost_ctx)]
        reps = [replicate(self._mesh, m) for m in models]
        carry_reps = [replicate(self._mesh, c) for c in carries1]
        ctx_reps = replicate(self._mesh, cost_ctx)
        return [(lo, hi, self._mesh.devices[i], [r[i] for r in reps],
                 [broadcast_carry(c[i], hi - lo) for c in carry_reps],
                 ctx_reps[i])
                for i, (lo, hi) in enumerate(shard_bounds(self._mesh, M))
                if hi > lo]

    def _roll_and_score(self, shards, plan, latent, keep):
        """Roll and score every share; returns the (M,) scores and, with
        ``keep``, the time-major compute-dtype videos and the distributions
        of all samples (else None), on the lead device."""
        scores, videos, distribs = [], [], []
        for lo, hi, dev, models, carries, cost_ctx in shards:
            gi, gd, gtm = self._rollout(
                models, carries, plan[lo:hi].to(dev),
                None if latent is None else latent[lo:hi].to(dev))
            scores.append(self._score(gi, gd, cost_ctx))
            videos.append(gtm if keep else None)
            distribs.append(gd if keep else None)
            del gi, gd, gtm

        def whole(pieces, dim=0):
            if len(pieces) == 1 or pieces[0] is None:
                return pieces[0]
            return gather(self._mesh, pieces, dim)
        return whole(scores), whole(videos, dim=1), whole(distribs)

    @staticmethod
    def _rollout(models, carries, plan, latent=None):
        """Roll all cameras from the pre-encoded carries, every camera under
        the same ``latent`` (B, latent_dim).

        :return: (M,T,ncam,H,W,C) f32, (M,T,ncam,H,W,P) f32,
            (T,M,ncam,H,W,C) in the compute dtype"""
        outs = [model.rollout_from(carry, plan, latent=latent)
                for model, carry in zip(models, carries)]
        return (torch.stack([o['gen_images'] for o in outs], dim=2),
                torch.stack([o['gen_distribs'] for o in outs], dim=2),
                torch.stack([o['gen_images_tm'] for o in outs], dim=2))

    def _score(self, gen_images, gen_distribs, cost_ctx):
        if self._cost_fn is not None:
            return self._cost_fn(gen_images, gen_distribs, cost_ctx)
        return cost_lib.expected_pixel_distance(
            gen_distribs, cost_ctx, self._finalweight, normalize=True,
            only_first_view=self._ofv)

    def _sample_gaussian(self, mean, sigma, M, generator, z):
        """(M, T, adim) Gaussian plans of one iteration."""
        kk = self._stoch_k
        plan = sample_actions(mean, sigma, self._spec, M // kk,
                              rejection_rounds=self._rej,
                              action_bound=self._bound, generator=generator,
                              z=z)
        if kk > 1:
            plan = torch.repeat_interleave(plan, kk, dim=0)
        for d in self._discrete:
            plan[..., d] = plan[..., d].floor().clamp(0.0, 4.0)
        if self._add_zero:
            plan[0] = 0.0
        return plan

    def _sample_mppi(self, mean, cov, anchor, anchor_valid, M, generator,
                     eps):
        """AR(1)-correlated noise around a mean plan (CorrelatedNoiseSampler):
        ``a_0 = b0 e_0 + b1 (anchor if anchor_valid else e_{n-1})``,
        ``a_t = b0 e_t + b1 a_{t-1}``.  With a refit covariance the normals
        are multiplied by the covariance itself, not by a square root of it,
        as the host sampler does.

        :param eps: (M, nactions*adim) standard normals, or None to draw
        """
        spec, hp = self._spec, self._mppi
        n, adim, dev = spec.nactions, spec.adim, mean.device
        if eps is None:
            eps = torch.randn((M, n * adim), generator=generator, device=dev)
        elif eps.numel() != M * n * adim:
            raise ValueError('MPPI normals have shape {}, expected {}'.format(
                tuple(eps.shape), (M, n * adim)))
        if cov is not None:
            noise = (eps.reshape(M, -1) @ cov).reshape(M, n, adim)
        else:
            noise = eps.reshape(M, n, adim) * self._mppi_scale + \
                self._mppi_bias
        b0, b1 = hp['beta_0'], hp['beta_1']
        prev = b0 * noise[:, 0] + b1 * (anchor_valid * anchor[None] +
                                        (1.0 - anchor_valid) * noise[:, -1])
        steps = [prev]
        for t in range(1, n):
            prev = b0 * noise[:, t] + b1 * prev
            steps.append(prev)
        return torch.stack(steps, dim=1) + mean.reshape(1, n, adim)

    def _mppi_update(self, elite_actions, elite_scores):
        """The elites' soft-weighted mean plan, ``S = exp(kappa * (r - max
        r))`` over rewards = negated costs, and with ``refit_cov`` their
        covariance (over N - 1)."""
        hp = self._mppi
        rewards = -elite_scores
        S = torch.exp(hp['kappa'] * (rewards - rewards.max()))
        mean_plan = torch.einsum('n,nta->ta', S, elite_actions) / \
            (S.sum() + 1e-4)
        cov = None
        if hp.get('refit_cov'):
            flat = elite_actions.reshape(elite_actions.shape[0], -1)
            centered = flat - flat.mean(dim=0, keepdim=True)
            cov = centered.T @ centered / max(flat.shape[0] - 1, 1)
        return mean_plan.reshape(-1), cov

    def _sample_plans(self, itr, M, mean, sigma, mppi_cov, anchor,
                      anchor_valid, context_states, grip_elites, generator,
                      draws):
        """(M, T, adim) candidate plans of iteration ``itr`` in this
        planner's mode.  ``draws`` holds the iteration's given draws ('z',
        and per mode 'way', 'eps', 'grip'), empty to draw from
        ``generator``."""
        spec, z = self._spec, draws.get('z')
        if self._mppi is not None:
            plan = self._sample_mppi(mean, mppi_cov, anchor, anchor_valid, M,
                                     generator, z)
        elif self._folding is not None:
            fo = self._folding
            plan = folding_sample(
                mean, sigma, context_states[-1, :2], M, spec,
                split_frac=fo.get('split_frac', 0.5),
                max_shift=tuple(fo.get('max_shift', (0.2, 0.2, 1.0 / 3))),
                first_itr=(itr == 0), generator=generator, draws=draws)
        else:
            plan = self._sample_gaussian(mean, sigma, M, generator, z)
        if self._ag_eps is not None:
            ae = self._ag_eps
            amount = max(int(M * ae.get('base_frac', 1.0) *
                             ae.get('base_frac_reduce', 0.3) ** itr), 1)
            state_z = context_states[-1, ae.get('state_z_index',
                                                ae['z_dim'])]
            plan = ag_epsilon_transform(
                plan, state_z, amount, ae['z_dim'], ae['grip_dim'],
                z_norm=ae.get('z_norm', 1.0),
                zthresh=ae.get('zthresh', 1.0 / 3),
                epsilon=ae.get('epsilon', 0.5), repeat=ae.get('repeat', 1),
                generator=generator, u=draws.get('grip'))
        if self._ag is not None:
            ag = self._ag
            close_cmd = ag.get('close_cmd', 1.0)
            open_cmd = ag.get('open_cmd', -1.0)
            if grip_elites is None:
                plan = autograsp_gripper_latch(
                    plan, context_states[-1, ag.get('state_z_index', 2)],
                    ag['z_thresh'], norm_factor=ag.get('norm_factor', 1.0),
                    reopen=ag.get('reopen', False), close_cmd=close_cmd,
                    open_cmd=open_cmd, z_index=ag.get('z_index', 2),
                    deviation_prob=ag.get('deviation_prob', 0.0),
                    generator=generator, u=draws.get('grip'))
            else:
                grip = autograsp_gripper_resample(
                    grip_elites, M, plan.shape[1], close_cmd=close_cmd,
                    open_cmd=open_cmd, generator=generator,
                    u=draws.get('grip'))
                plan = torch.cat([plan, grip[..., None]], dim=-1)
        return plan

    @torch.no_grad()
    def replan(self, models, context_images, context_states,
               context_distribs, context_actions, cost_ctx, mean, sigma,
               generator=None, noise=None, latents=None, vis_latents=None,
               num_samples=None, anchor=None, anchor_valid=0.0):
        """One full replan.

        :param models: one ``CDNAPredictor`` per camera
        :param context_images: (ncam, n_ctx, H, W, C) float [0,1]
        :param context_states: (n_ctx, sdim)
        :param context_distribs: (ncam, n_ctx, H, W, P)
        :param context_actions: (n_ctx - 1, adim) executed actions
        :param cost_ctx: (ncam, P, H, W) goal distance grids (or whatever
            ``cost_fn`` reads)
        :param mean/sigma: current sampling distribution (flattened plan)
        :param generator: ``torch.Generator`` on the planner's device for
            every draw (plans, grip commands, latents), or
        :param noise: the draws given, indexed by iteration.  An entry is
            the plan normals: (M / stochastic_k, nactions*adim), or (1 +
            rejection_rounds, M / stochastic_k, nactions*adim) with
            rejection sampling; (M, nactions*adim) in MPPI mode.  Or it is a
            dict of them under 'z' with the mode's other draws: 'way' (2p,
            2, 2) uniforms and 'eps' (2p, nactions, 4) normals in folding
            mode ('z' then holds the (M - 2p, nactions*adim) Gaussian
            rows); 'grip' uniforms for the AutograspEpsilon flips (amount,
            T), the autograsp latch's deviations or its resample (M, T)
        :param latents: (iterations, M, latent_dim) latents of the scored
            rollouts (sample i of a chunked replan keeps row i); needed with
            ``noise`` when the models have a latent
        :param vis_latents: (n_vis, latent_dim) latents of the chunked
            replan's visualisation re-roll
        :param num_samples: M for this replan (defaults to the configured
            count; warm starts shrink it by ``reuse_factor``)
        :param anchor/anchor_valid: MPPI mode: the last executed action
            (adim,) and 1.0 to start the AR(1) chain from it (0.0: from the
            last step's noise)
        :return: dict with best actions, scores, refit mean/sigma (MPPI:
            the mean plan, sigma as given), vis
        """
        K, kk = self._K, self._stoch_k
        M = num_samples or self._M
        dev = self.device
        if (generator is None) == (noise is None):
            raise ValueError('pass exactly one of generator and noise')
        if K > M:
            raise ValueError('k_elite {} exceeds this replan\'s {} samples'
                             .format(K, M))
        if M % kk:
            raise ValueError('this replan\'s {} samples are no multiple of '
                             'stochastic_k {}'.format(M, kk))
        if self._stoch_penalty and K > M // kk:
            raise ValueError('k_elite {} exceeds this replan\'s {} unique '
                             'plans'.format(K, M // kk))
        latent_dim = models[0].latent_dim if models else 0
        if latent_dim and latents is None and generator is None:
            raise ValueError('a latent model needs latents beside noise')
        as_dev = lambda x: x.to(dev, torch.float32) \
            if isinstance(x, torch.Tensor) else \
            torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
        context_images, context_states = as_dev(context_images), \
            as_dev(context_states)
        context_distribs, context_actions = as_dev(context_distribs), \
            as_dev(context_actions)
        mean, sigma = as_dev(mean), as_dev(sigma)
        anchor = torch.zeros(self._spec.adim, device=dev) if anchor is None \
            else as_dev(anchor)
        anchor_valid = float(anchor_valid)
        if self._cost_fn is None:
            cost_ctx = as_dev(cost_ctx)
        if latents is not None:
            latents = as_dev(latents)

        def iteration_draws(itr):
            """The given draws of iteration ``itr`` on the device."""
            if noise is None:
                return {}
            given = noise[itr]
            if not isinstance(given, dict):
                given = {'z': given}
            return {k: as_dev(v) for k, v in given.items()}

        def draw_latent(given, b):
            """(b, latent_dim) latent for one rollout: the given rows, or a
            fresh draw; None for a deterministic model."""
            if not latent_dim:
                return None
            if given is not None:
                return given
            return torch.randn((b, latent_dim), generator=generator,
                               device=dev)

        # chunked mode: the rollout batch is sample_chunk, not M (unchunked
        # for warm-start sample counts the chunk does not divide)
        chunk = self._chunk
        use_chunk = bool(chunk) and M > chunk and M % chunk == 0
        shards = self._shards(models, self._encode_contexts(
            models, context_images, context_states, context_distribs,
            context_actions), cost_ctx, M, chunk if use_chunk else 0)
        carries = shards[0][4]
        sigma_prev = sigma
        mppi_cov = None
        grip_elites = None      # autograsp, no_refit False: last elites
        plan_scores, vis = [], None
        for itr in range(self._iterations):
            plan = self._sample_plans(itr, M, mean, sigma, mppi_cov, anchor,
                                      anchor_valid, context_states,
                                      grip_elites, generator,
                                      iteration_draws(itr))
            given = None if latents is None else latents[itr]
            if use_chunk:
                chunk_scores = []
                for lo in range(0, M, chunk):
                    rows = slice(lo, lo + chunk)
                    gi, gd, _ = self._rollout(
                        models, carries, plan[rows], draw_latent(
                            None if given is None else given[rows], chunk))
                    chunk_scores.append(self._score(gi, gd, cost_ctx))
                    del gi, gd
                scores = torch.cat(chunk_scores)
            else:
                scores, gen_images_tm, gen_distribs = self._roll_and_score(
                    shards, plan, draw_latent(given, M),
                    keep=itr == self._iterations - 1 and self._n_vis > 0)

            if self._stoch_penalty:
                # aggregate the copies of each unique plan: mean + penalty *
                # std (over N, not N - 1), then select groups; the first
                # row of a group stands for its plan
                g = scores.reshape(M // kk, kk)
                group_scores = g.mean(dim=1) + \
                    self._stoch_penalty * g.std(dim=1, correction=0)
                top, elite_gidx = _lowest(group_scores, K)
                elite_idx = elite_gidx * kk
            else:
                top, elite_idx = _lowest(scores, K)
            elite_actions = plan[elite_idx]
            plan_scores.append(scores)

            if itr == self._iterations - 1:
                nv = self._n_vis
                if nv and use_chunk:
                    # the chunks' videos are gone: re-roll the nv elites
                    # (under a latent of their own: vis illustrates, the
                    # scores decide)
                    idx = elite_idx[:nv]
                    nv = idx.shape[0]       # fewer than n_vis elites
                    if latent_dim and latents is not None and \
                            vis_latents is None:
                        raise ValueError('a chunked replan of a latent model '
                                         'needs vis_latents beside latents')
                    _, vd, vtm = self._rollout(
                        models, [_first_rows(c, nv) for c in carries],
                        plan[idx], draw_latent(
                            None if vis_latents is None
                            else as_dev(vis_latents), nv))
                    vis = {'indices': idx,
                           'gen_images': vtm.transpose(0, 1).float(),
                           'gen_distribs': vd, 'scores': top[:nv]}
                elif nv:
                    idx = elite_idx[:nv]
                    vis = {
                        'indices': idx,
                        'gen_images': gen_images_tm[:, idx].transpose(
                            0, 1).float(),
                        'gen_distribs': gen_distribs[idx],
                        'scores': top[:nv],
                    }
            elif self._mppi is not None:
                mean, mppi_cov = self._mppi_update(elite_actions, top)
            else:
                refit_elites = elite_actions
                if self._ag is not None:
                    # the derived grip dim is never refit
                    refit_elites = elite_actions[..., :-1]
                    if not self._ag.get('no_refit', True):
                        grip_elites = elite_actions
                mean, sigma = fit_elites(refit_elites, self._spec,
                                         blockdiag=self._blockdiag)
                if self._smooth_cov:
                    sigma = (sigma + sigma_prev) / 2.0
                    sigma_prev = sigma
        return {
            'best_actions': elite_actions,        # (K, T, adim) best first
            'best_scores': top,                   # (K,)
            'scores_per_itr': torch.stack(plan_scores),   # (iters, M)
            'mean': mean,
            'sigma': sigma,
            'vis': vis,
        }
