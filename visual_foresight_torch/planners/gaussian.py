"""Gaussian CEM action distribution (PyTorch).

Counterpart of ``visual_foresight_tpu/planners/gaussian.py``: full-covariance
sampling over the flattened (nactions*adim) plan via Cholesky, a
per-dimension std table keyed by ``action_order``, bounded rejection sampling
(a fixed number of resample rounds, then a clamp), repeat expansion, xy/theta
truncation, the elite mean/covariance refit and the between-replan
covariance shift.
"""

from typing import NamedTuple

import numpy as np
import torch

MAX_ROT = np.pi / 4


class ActionSpec(NamedTuple):
    """Static description of the action distribution."""
    adim: int
    nactions: int
    repeat: int
    per_dim_std: tuple           # len adim, initial std per dim
    clip_dims_xy: tuple          # dims clipped to +-2*initial_std (x/y)
    clip_dims_rot: tuple         # dims clipped to +-pi/4 (theta)
    rej_dims_xy: tuple           # dims rejection-bounded at 1.5*xy std
    rej_dims_lift: tuple         # dims rejection-bounded at 1.5*lift std
    xy_std: float
    lift_std: float


def make_action_spec(hp_dict, adim):
    """Build an ActionSpec from controller hparams (initial_std,
    initial_std_lift, initial_std_rot, initial_std_grasp, action_order,
    nactions, repeat)."""
    xy_std = hp_dict['initial_std']
    lift_std = hp_dict['initial_std_lift']
    table = {'x': xy_std, 'y': xy_std, 'z': lift_std,
             'theta': hp_dict['initial_std_rot'],
             'grasp': hp_dict['initial_std_grasp']}
    order = hp_dict.get('action_order')
    if order is not None:
        stds = [table[a] for a in order]
        clip_xy = tuple(i for i, a in enumerate(order) if a in ('x', 'y'))
        clip_rot = tuple(i for i, a in enumerate(order) if a == 'theta')
        rej_lift = tuple(i for i, a in enumerate(order) if a == 'z')
    else:
        stds = [table[n] for n in ['x', 'y', 'z', 'theta', 'grasp'][:adim]]
        clip_xy = tuple(range(min(2, adim)))
        clip_rot = (3,) if adim >= 4 else ()
        rej_lift = (2,) if adim >= 3 else ()
    return ActionSpec(adim=len(stds), nactions=hp_dict['nactions'],
                      repeat=hp_dict['repeat'], per_dim_std=tuple(stds),
                      clip_dims_xy=clip_xy, clip_dims_rot=clip_rot,
                      rej_dims_xy=clip_xy, rej_dims_lift=rej_lift,
                      xy_std=xy_std, lift_std=lift_std)


def initial_sigma(spec: ActionSpec, reduce_std_dev: float = 1.0,
                  reduce: bool = False, device=None):
    """Diagonal covariance over the flattened plan."""
    diag = np.tile(np.square(np.array(spec.per_dim_std)), spec.nactions)
    if reduce:
        diag[:(spec.nactions - 1) * spec.adim] *= reduce_std_dev
    return torch.tensor(np.diag(diag), dtype=torch.float32, device=device)


def initial_mean(spec: ActionSpec, device=None):
    return torch.zeros(spec.adim * spec.nactions, device=device)


def _plan_bounds(spec: ActionSpec, factor: float, device=None):
    """(lo, hi) per flattened-plan dim for rejection bounds; +-inf
    elsewhere."""
    lo = np.full(spec.adim, -np.inf, np.float32)
    hi = np.full(spec.adim, np.inf, np.float32)
    for d in spec.rej_dims_xy:
        lo[d], hi[d] = -factor * spec.xy_std, factor * spec.xy_std
    for d in spec.rej_dims_lift:
        lo[d], hi[d] = -factor * spec.lift_std, factor * spec.lift_std
    return (torch.tensor(np.tile(lo, spec.nactions), device=device),
            torch.tensor(np.tile(hi, spec.nactions), device=device))


def truncate(actions, spec: ActionSpec):
    """Clip xy to +-2*xy_std and theta to +-pi/4 over (..., adim)."""
    actions = actions.clone()
    maxshift = 2.0 * spec.xy_std
    for d in spec.clip_dims_xy:
        actions[..., d] = actions[..., d].clamp(-maxshift, maxshift)
    for d in spec.clip_dims_rot:
        actions[..., d] = actions[..., d].clamp(-MAX_ROT, MAX_ROT)
    return actions


def sample_actions(mean, sigma, spec: ActionSpec, nsamples: int,
                   rejection_rounds: int = 0, action_bound: bool = True,
                   generator=None, z=None):
    """Draw nsamples plans, repeat-expanded to
    (nsamples, nactions*repeat, adim).

    ``rejection_rounds`` > 0 resamples, that many times, every plan with a
    dim outside 1.5 std of its xy or lift bound, then clamps what is still
    outside.  The standard normals come from ``generator`` or are given as
    ``z``: (nsamples, nactions*adim), or (1 + rejection_rounds, nsamples,
    nactions*adim) with rejection (the first draw, then one per round).  A
    covariance that Cholesky cannot factor (singular elite refits) falls
    back to its diagonal, without a host synchronisation.
    """
    dim = spec.adim * spec.nactions
    dev = sigma.device
    eye = torch.eye(dim, dtype=sigma.dtype, device=dev)
    chol, info = torch.linalg.cholesky_ex(sigma + 1e-10 * eye)
    diag = torch.sqrt(torch.clamp(torch.diagonal(sigma), min=1e-12))
    bad = (info != 0) | torch.isnan(chol)
    chol = torch.where(bad, diag[:, None] * eye, chol)
    if z is None:
        z = torch.randn((1 + rejection_rounds, nsamples, dim),
                        generator=generator, device=dev)
    else:
        z = z.to(dev)
        if rejection_rounds == 0 and z.dim() == 2:
            z = z[None]
        if tuple(z.shape) != (1 + rejection_rounds, nsamples, dim):
            raise ValueError('z has shape {}, expected {}'.format(
                tuple(z.shape), (1 + rejection_rounds, nsamples, dim)))
    draw = lambda i: mean[None] + z[i] @ chol.T
    flat = draw(0)
    if rejection_rounds > 0:
        lo, hi = _plan_bounds(spec, 1.5, device=dev)
        for i in range(rejection_rounds):
            invalid = ((flat < lo[None]) | (flat > hi[None])).any(dim=1)
            flat = torch.where(invalid[:, None], draw(1 + i), flat)
        flat = torch.minimum(torch.maximum(flat, lo[None]), hi[None])
    actions = flat.reshape(nsamples, spec.nactions, spec.adim)
    if action_bound:
        actions = truncate(actions, spec)
    return torch.repeat_interleave(actions, spec.repeat, dim=1)


def fit_elites(elite_actions, spec: ActionSpec, blockdiag: bool = False):
    """Refit (mean, sigma) from elite plans: keep one action per repeat
    block, flatten, unbiased covariance."""
    k = elite_actions.shape[0]
    acts = elite_actions.reshape(k, spec.nactions, spec.repeat, spec.adim)
    acts = acts[:, :, -1, :].reshape(k, spec.nactions * spec.adim)
    mean = acts.mean(dim=0)
    centered = acts - mean[None]
    sigma = centered.T @ centered / max(k - 1, 1)
    if blockdiag:
        mask = np.zeros((spec.nactions * spec.adim,) * 2, np.float32)
        for i in range(spec.nactions - 1):
            a = i * spec.adim
            mask[a:a + 2 * spec.adim, a:a + 2 * spec.adim] = 1.0
        sigma = sigma * torch.tensor(mask, device=sigma.device)
    return mean, sigma


def shift_sigma(sigma, spec: ActionSpec, reuse_fraction: float):
    """Between-replan covariance shift: drop the executed action block, add
    ``reuse_fraction`` of the initial variances to the rest, and start the
    new last block at the initial variances."""
    adim, n = spec.adim, spec.nactions
    dim = adim * n
    init = initial_sigma(spec, device=sigma.device).to(sigma.dtype)
    out = torch.zeros_like(sigma)
    out[:dim - adim, :dim - adim] = sigma[adim:, adim:] + \
        init[:dim - adim, :dim - adim] * reuse_fraction
    out[dim - adim:, dim - adim:] = init[:adim, :adim]
    return out
