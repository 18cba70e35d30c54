"""Planning costs (PyTorch): counterpart of
``visual_foresight_tpu/planners/costs.py`` (expected pixel distance,
goal-image MSE, the success classifier's and the ensemble's costs)."""

import torch


def distance_grid(goal_pix, height, width, device=None):
    """(..., 2) goal pixels -> (..., H, W) Euclidean distance grids."""
    goal = torch.as_tensor(goal_pix, dtype=torch.float32, device=device)
    rows = torch.arange(height, dtype=torch.float32, device=goal.device)
    cols = torch.arange(width, dtype=torch.float32, device=goal.device)
    rr, cc = torch.meshgrid(rows, cols, indexing='ij')
    dr = rr - goal[..., 0:1, None]
    dc = cc - goal[..., 1:2, None]
    return torch.sqrt(dr * dr + dc * dc)


def time_weights(horizon, finalweight, device=None):
    """Per-step weights: 1 everywhere, ``finalweight`` on the last step."""
    w = torch.ones(horizon, device=device)
    w[-1] = finalweight
    return w


def expected_pixel_distance(gen_distribs, dist_grids, finalweight=10.0,
                            normalize=True, only_first_view=False):
    """Expected distance of predicted pixel distributions to goal pixels.

    :param gen_distribs: (B, T, ncam, H, W, P)
    :param dist_grids: (ncam, P, H, W) precomputed distance grids
    :return: (B,) scores (lower = better), averaged over cams and tasks
    """
    d = gen_distribs.float()
    if normalize:
        tot = d.sum(dim=(3, 4), keepdim=True)
        d = d / torch.clamp(tot, min=1e-6)
    per_t = torch.einsum('btchwp,cphw->btcp', d, dist_grids.float())
    w = time_weights(per_t.shape[1], finalweight, device=per_t.device)
    per_task = (per_t * w[None, :, None, None]).sum(dim=1) / w.sum()
    if only_first_view:
        per_task = per_task[:, 0:1]
    return per_task.reshape(per_task.shape[0], -1).mean(dim=1)


def goal_image_mse(gen_images, goal_image, final_frames=1):
    """MSE between the last ``final_frames`` predicted frames and a goal
    image.

    :param gen_images: (B, T, ncam, H, W, C) in [0, 1]
    :param goal_image: (ncam, H, W, C)
    :return: (B,) scores (lower = better)
    """
    tail = gen_images[:, -final_frames:].float()
    diff = tail - goal_image[None, None].float()
    return diff.square().mean(dim=(1, 2, 3, 4, 5))


def classifier_logprob_cost(logits):
    """Success-classifier cost: -log p(success)."""
    return -torch.nn.functional.logsigmoid(logits.float())


def ensemble_cost(per_model_scores, lambda_var=1.0):
    """Ensemble disagreement cost: mean + lambda * (population) variance
    across model copies.

    :param per_model_scores: (n_ensemble, B)
    :return: (B,)
    """
    mean = per_model_scores.mean(dim=0)
    var = per_model_scores.var(dim=0, correction=0)
    return mean + lambda_var * var
