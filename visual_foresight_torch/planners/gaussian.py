"""Gaussian CEM action distribution (PyTorch).

Counterpart of ``visual_foresight_tpu/planners/gaussian.py``: full-covariance
sampling over the flattened (nactions*adim) plan via Cholesky, a
per-dimension std table keyed by ``action_order``, bounded rejection sampling
(a fixed number of resample rounds, then a clamp), repeat expansion, xy/theta
truncation, the elite mean/covariance refit, the between-replan
covariance shift, and the other samplers' device math: the autograsp latch
and resample, the AutograspEpsilon gripper and the folding prior.  Every
random draw comes from an explicit ``torch.Generator`` or is given as a
tensor.
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


def _uniform(shape, generator, given, device, name):
    """Uniform [0, 1) draws of ``shape``: ``given``, or from ``generator``."""
    if given is None:
        if generator is None:
            raise ValueError('pass a generator or the {} draws'.format(name))
        return torch.rand(shape, generator=generator, device=device)
    given = _as_float(given, device)
    if tuple(given.shape) != tuple(shape):
        raise ValueError('{} draws have shape {}, expected {}'.format(
            name, tuple(given.shape), tuple(shape)))
    return given


def _as_float(x, device):
    """``x`` (a tensor or an array) as an f32 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(device, torch.float32)


def autograsp_gripper_latch(base_actions, current_z, z_thresh,
                            norm_factor=1.0, reopen=False, close_cmd=1.0,
                            open_cmd=-1.0, z_index=2, deviation_prob=0.0,
                            generator=None, u=None):
    """AutograspSampler's cumulative-z gripper derivation: close where the
    cumulative z (from ``current_z``) is below ``z_thresh``, sticky unless
    ``reopen``, each step flipped with ``deviation_prob`` (uniforms ``u``
    of shape (M, T), or drawn from ``generator``).

    :param base_actions: (M, T, adim_base) sampled base plans
    :return: (M, T, adim_base + 1) plans with the grip command appended
    """
    z = base_actions[:, :, z_index]
    close = (torch.cumsum(z * norm_factor, dim=1) + current_z) < z_thresh
    if not reopen:
        close = torch.cumsum(close.int(), dim=1) > 0
    if deviation_prob:
        flip = _uniform(close.shape, generator, u, close.device,
                        'deviation') < deviation_prob
        close = close ^ flip
    grip = torch.where(close, close_cmd, open_cmd).to(base_actions.dtype)
    return torch.cat([base_actions, grip[..., None]], dim=-1)


def autograsp_gripper_resample(elite_actions, nsamples, nactions,
                               close_cmd=1.0, open_cmd=-1.0, generator=None,
                               u=None):
    """``no_refit=False``: each step's close probability from the elites'
    grip dim, then a Bernoulli grip command per fresh sample (uniforms
    ``u`` of shape (nsamples, nactions), or drawn from ``generator``)."""
    close_prob = (elite_actions[:, :, -1] == close_cmd).float().mean(dim=0)
    cmd = _uniform((nsamples, nactions), generator, u, elite_actions.device,
                   'resample') < close_prob[None]
    return torch.where(cmd, close_cmd, open_cmd).to(elite_actions.dtype)


def ag_epsilon_transform(plan, state_z, amount, z_dim, grip_dim, z_norm=1.0,
                         zthresh=1.0 / 3, epsilon=0.5, repeat=1,
                         generator=None, u=None):
    """AutograspEpsilon's gripper for the first ``amount`` plans: open before
    the first repeat boundary at or below the cumulative-z threshold, closed
    from it on (a plan that never reaches it closes at t=0, as the host's
    ``argmax`` does), then each step flipped with probability ``epsilon``
    (uniforms ``u`` of shape (amount, T), or drawn from ``generator``)."""
    T = plan.shape[1]
    cum = torch.cumsum(plan[:amount, :, z_dim] / z_norm, dim=1) + state_z
    close = cum <= zthresh
    tidx = torch.arange(T, device=plan.device)
    # the first True step, 0 where there is none (argmax semantics)
    first = torch.where(close, tidx[None], T).min(dim=1).values
    first = torch.where(first == T, 0, first)
    pivot = first - first % repeat
    grip = torch.where(tidx[None, :] >= pivot[:, None], 1.0, -1.0)
    flips = torch.where(_uniform(grip.shape, generator, u, plan.device,
                                 'epsilon') < epsilon, -1.0, 1.0)
    plan = plan.clone()
    plan[:amount, :, grip_dim] = (grip * flips).to(plan.dtype)
    return plan


def _psd_factor(sigma, eps=1e-10):
    """F with F @ F.T = the eigenvalue-clipped symmetric part of ``sigma``.
    The eigenvectors are fixed only up to sign (and within a repeated
    eigenvalue's space), so F may differ from another library's in its
    columns; F @ F.T does not."""
    sigma = 0.5 * (sigma + sigma.T)
    w, v = torch.linalg.eigh(sigma)
    return v * torch.sqrt(torch.clamp(w, min=eps))[None, :]


def folding_sample(mean, sigma, state_xy, nsamples, spec: ActionSpec,
                   split_frac=0.5, max_shift=(0.2, 0.2, 1.0 / 3),
                   first_itr=False, generator=None, draws=None):
    """FoldingCEMSampler's structured prior: a pick->fold->place group
    (waypoint-conditioned phase means, tight noise on the grasp phases), a
    direct move->descend group whose tail holds one draw, and the rest from
    the refit Gaussian; xy/z clipped to ``max_shift``, repeat-expanded.

    The draws come from ``generator`` or are given in ``draws``: 'way'
    (2p, 2, 2) uniform waypoints, 'eps' (2p, nactions, 4) and 'z'
    (nsamples - 2p, nactions*adim) standard normals, p the group size.
    """
    n, adim = spec.nactions, spec.adim
    if adim != 4:
        raise ValueError('the folding prior needs 4 base action dims')
    dev = sigma.device
    per_split = int((nsamples * split_frac) / 2)
    if first_itr:
        per_split = max(int(per_split / 2), 1)
    p2 = 2 * per_split
    n_def = nsamples - p2
    draws = draws or {}

    def normal(name, shape):
        given = draws.get(name)
        if given is None:
            if generator is None:
                raise ValueError('pass a generator or the {} draws'.format(
                    name))
            return torch.randn(shape, generator=generator, device=dev)
        given = _as_float(given, dev)
        if tuple(given.shape) != tuple(shape):
            raise ValueError('{} draws have shape {}, expected {}'.format(
                name, tuple(given.shape), tuple(shape)))
        return given

    f_base = _psd_factor(sigma[:4, :4])
    lower_sigma = sigma[:4, :4].clone()
    lower_sigma[:2, :2] /= 10.0
    lower_sigma[3, 3] /= 2.0
    f_lower = _psd_factor(lower_sigma)
    f_full = _psd_factor(sigma)

    way = _uniform((p2, 2, 2), generator, draws.get('way'), dev, 'way')
    eps = normal('eps', (p2, n, 4))
    steps = torch.arange(n, device=dev)
    lower_1 = (steps == 1) | (steps == 2) | (steps == 4)
    lower_2 = (steps == 0) | (steps >= 2)
    is_split2 = (torch.arange(p2, device=dev) >= per_split)[:, None]
    use_lower = torch.where(is_split2, lower_2[None, :], lower_1[None, :])
    noise = torch.where(use_lower[..., None], eps @ f_lower.T,
                        eps @ f_base.T)
    # the second group's tail repeats its step-3 draw
    hold = noise[:, 3:4, :]
    noise = torch.where((is_split2 & (steps >= 3)[None, :])[..., None],
                        hold, noise)

    first_pnt, second_pnt = way[:, 0], way[:, 1]
    state_xy = state_xy.to(dev).float()
    d1 = (first_pnt - state_xy[None]) / spec.repeat
    d2s1 = (second_pnt - first_pnt) / spec.repeat
    d2s2 = (second_pnt - state_xy[None]) / spec.repeat
    # group 1: move(d1, up), descend, up (grasp), move(d2, up), descend
    m1 = torch.zeros((p2, n, 4), device=dev)
    m1[:, 0, :2], m1[:, 0, 2] = d1, 1.0
    m1[:, 1, 2], m1[:, 2, 2] = -1.0, 1.0
    m1[:, 3, :2], m1[:, 3, 2] = d2s1, 1.0
    m1[:, 4, 2] = -1.0
    # group 2: up, move(d2, up), descend, hold
    m2 = torch.zeros((p2, n, 4), device=dev)
    m2[:, 0, 2] = 1.0
    m2[:, 1, :2], m2[:, 1, 2] = d2s2, 1.0
    m2[:, 2, 2] = -1.0
    structured = torch.where(is_split2[..., None], m2, m1) + noise
    if n_def > 0:
        flat = mean[None] + normal('z', (n_def, n * adim)) @ f_full.T
        plans = torch.cat([structured, flat.reshape(n_def, n, adim)], dim=0)
    else:
        plans = structured[:nsamples]
    for d, bound in enumerate(max_shift):
        plans[:, :, d] = plans[:, :, d].clamp(-bound, bound)
    return torch.repeat_interleave(plans, spec.repeat, dim=1)
