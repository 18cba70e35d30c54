"""CEM replanning on the device (PyTorch).

Counterpart of ``visual_foresight_tpu/planners/cem.py::FusedCEMPlanner`` in
its default Gaussian mode: encode the context once at batch 1 and broadcast
the carry over the samples, then for each iteration sample plans, roll them
out, score them by expected pixel distance, take the ``top_k`` elites and
refit.  The replan makes no host round trip until the caller reads a result.
"""

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.models.cdna import broadcast_carry
from visual_foresight_torch.planners import costs as cost_lib
from visual_foresight_torch.planners.gaussian import (ActionSpec, fit_elites,
                                                      sample_actions)

# the JAX planner's other arguments, at the values that leave them off
_UNPORTED_DEFAULTS = {
    'rejection_rounds': 0, 'smooth_cov': False, 'add_zero_action': False,
    'mppi': None, 'autograsp': None, 'stochastic_k': 1, 'discrete_dims': (),
    'ag_epsilon': None, 'folding': None, 'sample_chunk': 0,
    'stochastic_penalty': 0.0, 'mesh': None, 'cost_fn': None,
    'donate_dist': True,
}


class FusedCEMPlanner:
    """Runs Gaussian CEM replans through per-camera predictor modules.

    :param spec: ActionSpec (static sampling description)
    :param num_samples: M candidates per CEM iteration
    :param iterations: CEM iterations
    :param k_elite: elite count for the refit
    :param finalweight: last-step weight in the pixel cost
    :param action_bound: clip xy/theta after sampling
    :param n_vis: how many elite rollouts to return for visualization
    :param device: where the replan runs ('cuda' unless the caller asks for
        the CPU)

    The JAX planner's other modes (``_UNPORTED_DEFAULTS``: rejection
    sampling, MPPI, autograsp, ag_epsilon, folding, stochastic_k,
    sample_chunk, mesh sharding, custom costs and the remaining plan
    transforms) are not ported: any value other than the one that leaves
    a mode off raises ``NotImplementedError``.
    """

    def __init__(self, spec: ActionSpec, num_samples: int,
                 iterations: int = 3, k_elite: int = 10,
                 finalweight: float = 10.0, action_bound: bool = True,
                 only_first_view: bool = False, n_vis: int = 10,
                 blockdiag_refit: bool = False, device='cuda', **modes):
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
        self._bound = action_bound
        self._ofv = only_first_view
        self._n_vis = min(n_vis, num_samples)
        self._blockdiag = blockdiag_refit
        self.device = resolve_device(device)

    @property
    def spec(self):
        return self._spec

    @staticmethod
    def _encode_contexts(models, images, states, distribs, context_actions,
                         num_samples):
        """Consume the context once per camera at batch 1 and broadcast the
        carry across the samples."""
        carries = []
        for c, model in enumerate(models):
            carry1 = model.encode_context(images[c][None],
                                          context_actions[None],
                                          states[None], distribs[c][None])
            carries.append(broadcast_carry(carry1, num_samples))
        return carries

    @staticmethod
    def _rollout(models, carries, plan):
        """:return: (M,T,ncam,H,W,C) f32, (M,T,ncam,H,W,P) f32,
        (T,M,ncam,H,W,C) in the compute dtype"""
        outs = [model.rollout_from(carry, plan)
                for model, carry in zip(models, carries)]
        return (torch.stack([o['gen_images'] for o in outs], dim=2),
                torch.stack([o['gen_distribs'] for o in outs], dim=2),
                torch.stack([o['gen_images_tm'] for o in outs], dim=2))

    @torch.no_grad()
    def replan(self, models, context_images, context_states,
               context_distribs, context_actions, cost_ctx, mean, sigma,
               generator=None, noise=None, num_samples=None):
        """One full replan.

        :param models: one ``CDNAPredictor`` per camera
        :param context_images: (ncam, n_ctx, H, W, C) float [0,1]
        :param context_states: (n_ctx, sdim)
        :param context_distribs: (ncam, n_ctx, H, W, P)
        :param context_actions: (n_ctx - 1, adim) executed actions
        :param cost_ctx: (ncam, P, H, W) goal distance grids
        :param mean/sigma: current sampling distribution (flattened plan)
        :param generator: ``torch.Generator`` on the planner's device for
            the plan noise, or
        :param noise: (iterations, M, nactions*adim) standard normals
        :param num_samples: M for this replan (defaults to the configured
            count; warm starts shrink it by ``reuse_factor``)
        :return: dict with best actions, scores, refit mean/sigma, vis
        """
        spec, K = self._spec, self._K
        M = num_samples or self._M
        dev = self.device
        if (generator is None) == (noise is None):
            raise ValueError('pass exactly one of generator and noise')
        if K > M:
            raise ValueError('k_elite {} exceeds this replan\'s {} samples'
                             .format(K, M))
        as_dev = lambda x: x.to(dev, torch.float32) \
            if isinstance(x, torch.Tensor) else \
            torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)
        context_images, context_states = as_dev(context_images), \
            as_dev(context_states)
        context_distribs, context_actions = as_dev(context_distribs), \
            as_dev(context_actions)
        cost_ctx, mean, sigma = as_dev(cost_ctx), as_dev(mean), as_dev(sigma)
        if noise is not None:
            noise = as_dev(noise)

        carries = self._encode_contexts(models, context_images,
                                        context_states, context_distribs,
                                        context_actions, M)
        plan_scores, vis = [], None
        for itr in range(self._iterations):
            plan = sample_actions(
                mean, sigma, spec, M, action_bound=self._bound,
                generator=generator, z=None if noise is None else noise[itr])
            gen_images, gen_distribs, gen_images_tm = self._rollout(
                models, carries, plan)
            scores = cost_lib.expected_pixel_distance(
                gen_distribs, cost_ctx, self._finalweight, normalize=True,
                only_first_view=self._ofv)
            neg_top, elite_idx = torch.topk(-scores, K)
            elite_actions = plan[elite_idx]
            plan_scores.append(scores)
            if itr == self._iterations - 1:
                nv = self._n_vis
                if nv:
                    idx = elite_idx[:nv]
                    vis = {
                        'indices': idx,
                        'gen_images': gen_images_tm[:, idx].transpose(
                            0, 1).float(),
                        'gen_distribs': gen_distribs[idx],
                        'scores': -neg_top[:nv],
                    }
            else:
                mean, sigma = fit_elites(elite_actions, spec,
                                         blockdiag=self._blockdiag)
        return {
            'best_actions': elite_actions,        # (K, T, adim) best first
            'best_scores': -neg_top,              # (K,)
            'scores_per_itr': torch.stack(plan_scores),   # (iters, M)
            'mean': mean,
            'sigma': sigma,
            'vis': vis,
        }
