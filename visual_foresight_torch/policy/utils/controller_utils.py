"""Host-side action-distribution helpers shared by random policies and CEM.

Semantics mirror reference ``visual_mpc/policy/utils/controller_utils.py``:
per-dimension initial std table keyed by ``action_order`` (x/y/z/theta/grasp),
xy/theta clipping, between-MPC-step covariance reuse, block-diagonalisation and
gripper discretisation.  The port's own copy of
``visual_foresight_tpu/policy/utils/controller_utils.py`` (that package
imports JAX); the device equivalents live in ``planners/gaussian.py``, these
numpy versions serve the samplers' host draws.
"""

import numpy as np

MAX_ROT = np.pi / 4


def per_dim_variances(hp, adim):
    """Per-action-dimension variances from the hp std table.

    With ``action_order`` set, dims are looked up by name; otherwise positional
    convention (x, y, z, theta, grasp) trimmed to adim
    (reference ``controller_utils.py:47-75``).
    """
    xy_var = hp.initial_std ** 2
    if hp.action_order is not None:
        table = {
            'x': xy_var,
            'y': xy_var,
            'z': hp.initial_std_lift ** 2,
            'theta': hp.initial_std_rot ** 2,
            'grasp': hp.initial_std_grasp ** 2,
        }
        try:
            return np.array([table[a] for a in hp.action_order])
        except KeyError as e:
            raise NotImplementedError('unknown action dim name {}'.format(e))
    diag = [xy_var, xy_var]
    if adim >= 3:
        diag.append(hp.initial_std_lift ** 2)
    if adim >= 4:
        diag.append(hp.initial_std_rot ** 2)
    if adim == 5:
        diag.append(hp.initial_std_grasp ** 2)
    return np.array(diag)


def construct_initial_sigma(hp, adim, t=None):
    """Diagonal covariance over the flattened (nactions*adim) plan."""
    diag_block = per_dim_variances(hp, adim)
    adim = len(diag_block)
    diag = np.tile(diag_block, hp.nactions)
    if 'reduce_std_dev' in hp and t is not None and t >= 2:
        # shrink everything but the final (non-reusable) action block
        diag[:(hp.nactions - 1) * adim] *= hp.reduce_std_dev
    return np.diag(diag)


def _clip_dims(actions, hp, time_axis):
    maxshift = hp.initial_std * 2
    if hp.action_order is not None:
        for i, name in enumerate(hp.action_order):
            if name in ('x', 'y'):
                actions[..., i] = np.clip(actions[..., i], -maxshift, maxshift)
            elif name == 'theta':
                actions[..., i] = np.clip(actions[..., i], -MAX_ROT, MAX_ROT)
        return actions
    actions[..., :2] = np.clip(actions[..., :2], -maxshift, maxshift)
    if actions.shape[-1] >= 4:
        actions[..., 3] = np.clip(actions[..., 3], -MAX_ROT, MAX_ROT)
    return actions


def truncate_movement(actions, hp):
    """Clip xy translation to 2*std and rotation to pi/4
    (reference ``controller_utils.py:6-44``). Accepts (..., T, adim) or (T, adim)."""
    if actions.ndim not in (2, 3):
        raise NotImplementedError('expected rank-2 or rank-3 action array')
    return _clip_dims(actions, hp, actions.ndim - 2)


def reuse_cov(sigma, adim, hp):
    """Shift covariance one action block forward between MPC replans, refreshing
    the freed final block from the initial sigma (reference ``controller_utils.py:87-96``)."""
    new = np.zeros_like(sigma)
    init = construct_initial_sigma(hp, adim)
    # hp.reuse_cov doubles as the blend fraction when truthy
    new[:-adim, :-adim] = sigma[adim:, adim:] + init[:-adim, :-adim] * float(hp.reuse_cov)
    new[-adim:, -adim:] = init[:adim, :adim]
    return new


def make_blockdiagonal(cov, nactions, adim):
    """Zero all covariance entries beyond adjacent action-block pairs."""
    mask = np.zeros_like(cov)
    for i in range(nactions - 1):
        mask[i * adim:(i + 2) * adim, i * adim:(i + 2) * adim] = 1.0
    return cov * mask


def discretize(actions, M, naction_steps, discrete_ind):
    """Floor-and-clip listed dims into {0..4} (reference ``controller_utils.py:107``)."""
    for ind in discrete_ind:
        actions[..., ind] = np.clip(np.floor(actions[..., ind]), 0, 4)
    return actions
