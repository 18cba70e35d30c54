"""Plain reference of one CEM replan, following a given elite path.

A replan samples plans from a Gaussian over the flattened plan (the
Cholesky factor of the covariance, or its diagonal where the factor does
not exist, as the refit from fewer elites than plan dimensions makes it
singular), clips the x/y dimensions to twice their initial std and theta to
pi/4, repeats each action ``repeat`` times, rolls every plan out through the
predictor, scores it by the expected distance of its predicted designated
pixel to the goal, keeps the ``k_elite`` lowest scores and refits the mean
and covariance to them.

Near-tied scores can be ordered differently in another precision, and one
other elite changes every later plan.  So :func:`judge` takes the elites of
each iteration from the scores it is given (the program's, or the control's
own) and recomputes everything else: the plans, every sample's score, the
refit and the returned best plans.  It imports nothing of the program.

:func:`judge` knows no architecture.  It drives the predictor through a
``Reference``, the class that the configuration's module
``perfbench/archs/<config>.py`` exports (``spec.arch``), which gives:

- ``Reference(cfg, weights, num_distribs, device, precision)``: ``weights``
  as that module's ``param_specs(cfg)`` names them (any dtype and device),
  ``num_distribs`` the designated pixels a camera (P), ``precision`` one of
  'f32' (the reference proper), 'served' (float32 arithmetic, with what the
  configuration's serving path stores rounded to its dtype) and 'lower'
  (the control, one precision below the program's);
- ``.device``, where it computes, and ``.lower``, True for 'lower' (the
  planner's own float32 products then run with TF32 operands);
- ``encode(images, distribs, states, actions)``: one camera's context,
  images (n_ctx, H, W, 3), distribs (n_ctx, H, W, P), states (n_ctx,
  sdim) and actions (n_ctx - 1, adim), all float32 on ``.device``, to a
  carry at batch 1, opaque to the planner;
- ``rollout(carry, plans, latents)``: plans (B, T, adim) rolled from that
  carry, latents (B, latent_dim) or None, to the predicted distributions
  (B, T, H, W, P).
"""

import contextlib

import numpy as np
import torch

from perfbench.reference.model import expected_distance, tf32

MAX_ROT = np.pi / 4


def plan_std(traffic, adim):
    """Initial std of each action dimension, by ``action_order`` (x, y, z,
    theta, grasp in that order where it is not given)."""
    table = {'x': traffic['initial_std'], 'y': traffic['initial_std'],
             'z': traffic['initial_std_lift'],
             'theta': traffic['initial_std_rot'],
             'grasp': traffic['initial_std_grasp']}
    order = traffic.get('action_order') or \
        ['x', 'y', 'z', 'theta', 'grasp'][:adim]
    if len(order) != adim:
        raise ValueError('action_order names {} dims, the model takes {}'
                         .format(len(order), adim))
    return order, [table[a] for a in order]


def initial_distribution(traffic, adim, device):
    """(mean, covariance) of the flattened plan before the first iteration:
    zero mean, the squared initial stds on the diagonal."""
    _, std = plan_std(traffic, adim)
    var = np.tile(np.square(np.asarray(std, np.float64)), traffic['nactions'])
    return (torch.zeros(var.size, device=device),
            torch.tensor(np.diag(var), dtype=torch.float32, device=device))


def _product(a, b, lower):
    return tf32(a) @ tf32(b) if lower else a @ b


def sample(mean, cov, z, traffic, adim, lower=False):
    """Plans (B, nactions * repeat, adim) from standard normals ``z`` (B,
    nactions * adim); ``lower``: the product in TF32."""
    dim = mean.shape[0]
    eye = torch.eye(dim, device=cov.device)
    factor, info = torch.linalg.cholesky_ex(cov + 1e-10 * eye)
    if int(info) != 0 or bool(torch.isnan(factor).any()):
        factor = torch.diag(torch.sqrt(torch.clamp(torch.diagonal(cov),
                                                   min=1e-12)))
    flat = mean[None] + _product(z, factor.t(), lower)
    plans = flat.reshape(z.shape[0], traffic['nactions'], adim).clone()
    if traffic['action_bound']:
        order, _ = plan_std(traffic, adim)
        bound = 2.0 * traffic['initial_std']
        for d, name in enumerate(order):
            if name in ('x', 'y'):
                plans[..., d] = plans[..., d].clamp(-bound, bound)
            elif name == 'theta':
                plans[..., d] = plans[..., d].clamp(-MAX_ROT, MAX_ROT)
    return torch.repeat_interleave(plans, traffic['repeat'], dim=1)


def refit(elites, traffic, lower=False):
    """Mean and unbiased covariance of the elites' decision actions;
    ``lower``: the product in TF32."""
    k, adim = elites.shape[0], elites.shape[-1]
    acts = elites.reshape(k, traffic['nactions'], traffic['repeat'], adim)
    flat = acts[:, :, -1].reshape(k, -1)
    mean = flat.mean(dim=0)
    centered = flat - mean[None]
    return mean, _product(centered.t(), centered, lower) / max(k - 1, 1)


def lowest(scores, k):
    """Indices of the ``k`` lowest scores, ties to the lower index."""
    order = np.argsort(np.asarray(scores), kind='stable')
    return order[:k]


def judge(ref, traffic, inputs, elite_scores, block=256, keep_best=False):
    """Recompute one replan along the elite path that ``elite_scores`` set.

    :param ref: a ``Reference`` (see the module's docstring)
    :param inputs: dict of the replan's inputs: 'images' (ncam, n_ctx, H, W,
        3), 'distribs' (ncam, n_ctx, H, W, P), 'states' (n_ctx, sdim),
        'actions' (n_ctx - 1, adim), 'grids' (ncam, P, H, W), 'noise'
        (iterations, M, nactions * adim), 'latents' (iterations, M,
        latent_dim) or None, and optionally 'vis_latents' (n, latent_dim) or
        None: a chunked replan re-rolls its best plans under these
    :param elite_scores: (iterations, M) scores whose ``k_elite`` lowest are
        each iteration's elites
    :param keep_best: also return the predicted distributions of the last
        iteration's best plan (T, ncam, H, W, P); under 'vis_latents', its
        re-roll under their first row
    :return: dict of 'scores' (iterations, M) and 'best_plans' (k_elite, T,
        adim), the plans at the last iteration's elites (and 'best_distribs')
    """
    with exact_f32():
        return _judge(ref, traffic, inputs, elite_scores, block, keep_best)


def _judge(ref, traffic, inputs, elite_scores, block, keep_best):
    dev = ref.device
    as_dev = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                       device=dev)
    images, distribs = as_dev(inputs['images']), as_dev(inputs['distribs'])
    states, actions = as_dev(inputs['states']), as_dev(inputs['actions'])
    grids = as_dev(inputs['grids'])
    noise = inputs['noise']
    latents = inputs['latents']
    vis = inputs.get('vis_latents')
    adim = actions.shape[-1]
    iterations, k = traffic['iterations'], traffic['k_elite']
    ncam = images.shape[0]
    carries = [ref.encode(images[c], distribs[c], states, actions)
               for c in range(ncam)]
    mean, cov = initial_distribution(traffic, adim, dev)
    all_scores, best_plans, best_distribs = [], None, None
    for itr in range(iterations):
        plans = sample(mean, cov, as_dev(noise[itr]), traffic, adim,
                       ref.lower)
        lat = None if latents is None else as_dev(latents[itr])
        elite = lowest(elite_scores[itr], k)
        last = itr == iterations - 1
        scores = []
        for lo in range(0, plans.shape[0], block):
            rows = slice(lo, lo + block)
            dists = torch.stack(
                [ref.rollout(carry, plans[rows],
                             None if lat is None else lat[rows])
                 for carry in carries], dim=2)
            scores.append(expected_distance(dists, grids,
                                            traffic['finalweight']))
            if keep_best and last and vis is None and \
                    lo <= elite[0] < lo + block:
                best_distribs = dists[elite[0] - lo].cpu().numpy()
            del dists
        all_scores.append(torch.cat(scores))
        elites = plans[torch.as_tensor(elite, device=dev)]
        if last:
            best_plans = elites
            if keep_best and vis is not None:
                best_distribs = torch.stack(
                    [ref.rollout(carry, elites[:1], as_dev(vis)[:1])
                     for carry in carries], dim=2)[0].cpu().numpy()
        else:
            mean, cov = refit(elites, traffic, ref.lower)
    out = {'scores': torch.stack(all_scores).cpu().numpy(),
           'best_plans': best_plans.cpu().numpy()}
    if keep_best:
        out['best_distribs'] = best_distribs
    return out


@contextlib.contextmanager
def exact_f32():
    """Within the block, float32 products run in float32 (TF32 off in
    cuBLAS and cuDNN); the settings before it come back after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def make_reference(arch, cfg, weights, traffic, device, precision='f32'):
    """The ``Reference`` of ``arch``, a configuration's architecture
    module, for a cell."""
    return arch.Reference(cfg, weights, traffic['designated_pixels'], device,
                          precision=precision)
