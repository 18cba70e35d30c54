"""Gaussian CEM sampler: its hparams and bookkeeping.

Counterpart of ``visual_foresight_tpu/policy/cem_controllers/samplers/
gaussian_sampler.py``.  The port plans on the device
(``planners/cem.py``), which draws, truncates and refits the Gaussian
itself; the controller reads from this class only its default hparams (they
fill the controller's namespace) and the executed-action / best-plan log
that warm starts read.  The host draw methods, used by the host CEM loop,
are not ported: ``CEMSampler``'s raise.
"""

import numpy as np

from .cem_sampler import CEMSampler


class GaussianCEMSampler(CEMSampler):
    """Multivariate Gaussian over flattened (nactions * adim) plans, refit to
    the elite set each CEM iteration.  Plans are sampled at the *decision*
    cadence and expanded by ``repeat`` to the control cadence."""

    @staticmethod
    def get_default_hparams():
        return {
            'action_order': None,
            'initial_std': 0.05,            # xy std dev
            'initial_std_lift': 0.15,
            'initial_std_rot': np.pi / 18,
            'initial_std_grasp': 2,
            'discrete_ind': None,
            'reuse_mean': False,
            'reduce_std_dev': 1.,           # std shrink when warm-starting
            'reuse_cov': False,
            'rejection_sampling': True,
            'cov_blockdiag': False,
            'smooth_cov': False,
            'nactions': 5,
            'repeat': 3,
            'add_zero_action': False,
            'action_bound': True,
            'reuse_factor': 0.5,            # sample-count shrink on reuse
            'stochastic_planning': None,
        }
