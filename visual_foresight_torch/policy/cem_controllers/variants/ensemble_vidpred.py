"""Ensemble-disagreement CEM controller (PyTorch port).

Counterpart of ``visual_foresight_tpu/policy/cem_controllers/variants/
ensemble_vidpred.py``: each plan is scored by ``num_ensembles`` predictor
members, and the cost is the mean plus ``ensemble_var_lambda`` times the
(population) variance of the members' expected pixel distances.

``model_path`` may be a list of member directories, each restored by the
predictor class and carried into a copy of the main predictor's camera-0
module (the members lend their weights, the main predictor its
architecture and dtype, as the JAX package stacks the members' parameters
under the main model).  Without a list every member is the one restore.

The JAX package ``vmap``s the member forward over the stacked parameters;
here the members run in turn, each as one full-batch teacher-forced forward
over the context action and the plan (the tail kernel is a ctypes launch,
which ``torch.func`` cannot batch).  ``perform_CEM`` is JAX's host loop:
Gaussian plans with no rejection rounds, the elites by numpy ``argsort``,
the refit by ``fit_elites``.  The plan normals (and the latents of a
stochastic model, one draw an iteration shared by the members) come from
the controller's ``torch.Generator``; ``_draw_normals`` is the one place
they are drawn.
"""

import copy

import numpy as np
import torch

from visual_foresight_torch.planners import costs as cost_lib
from visual_foresight_torch.planners.gaussian import (fit_elites,
                                                      initial_mean,
                                                      initial_sigma,
                                                      make_action_spec,
                                                      sample_actions)
from ..pixel_cost_controller import PixelCostController


class CEMControllerEnsembleVidPred(PixelCostController):
    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        super().__init__(ag_params, policyparams, gpu_id, ngpu)
        n_ens = self._hp.num_ensembles
        main = self.predictor.models[0]
        if isinstance(self._hp.model_path, (list, tuple)):
            if len(self._hp.model_path) != n_ens:
                raise ValueError('{} member paths for {} ensemble members'
                                 .format(len(self._hp.model_path), n_ens))
            self.members, self.members_restored = [], []
            for path in self._hp.model_path:
                # read in f32: the member lends its weights whole, the
                # copy of the main module casts them to its own dtype
                p = self._hp.predictor_class(
                    path, {'ncam': self._n_cam, 'dtype': 'float32',
                           'img_dims': (self._img_height, self._img_width),
                           'adim': self._adim, 'sdim': self._sdim,
                           'designated_pixel_count': self._n_desig,
                           'sequence_length': self._hp.T + 2},
                    device=self.device)
                p.restore()
                member = copy.deepcopy(main)
                member.load_state_dict(p.models[0].state_dict())
                self.members.append(member)
                self.members_restored.append(p.restored)
        else:
            self.members = [main] * n_ens
            self.members_restored = [self.predictor.restored] * n_ens

    def _default_hparams(self):
        parent_params = super()._default_hparams()
        parent_params.add_hparam('num_ensembles', 3)
        parent_params.add_hparam('ensemble_var_lambda', 1.0)
        # model_path may be a list of member directories: clear the
        # str-typed default so that the override check takes either form
        parent_params.set_hparam('model_path', None)
        return parent_params

    def _draw_normals(self, m, dim):
        """(m, dim) standard normals of one iteration's plans."""
        return torch.randn((m, dim), generator=self._generator,
                           device=self.device)

    @torch.no_grad()
    def _ensemble_cost(self, images, states, distribs, full_actions):
        """(E, M) member scores -> (M,) ensemble costs, each member one
        teacher-forced forward over ``full_actions`` from camera 0's
        context."""
        m = full_actions.shape[0]
        n_ctx = self.predictor.n_context
        tile = lambda x: x[None].expand((m,) + x.shape)
        latent = None
        if self.members[0].latent_dim:
            latent = torch.randn((m, self.members[0].latent_dim),
                                 generator=self._generator,
                                 device=self.device)
        grids = self._cost_grids()
        per_model = []
        for member in self.members:
            out = member(tile(images), full_actions, tile(states),
                         tile(distribs), latent=latent)
            gd = out['gen_distribs'][:, n_ctx - 1:][:, :, None]
            per_model.append(cost_lib.expected_pixel_distance(
                gd, grids, self._hp.finalweight))
        return cost_lib.ensemble_cost(torch.stack(per_model),
                                      self._hp.ensemble_var_lambda)

    def perform_CEM(self, state):
        """CEM with ensemble scoring: Gaussian sampling and the refit on the
        device, the elites chosen on the host."""
        dev = self.device
        spec = make_action_spec(self._hp.values(), self._adim)
        n_ctx = self.predictor.n_context
        frames = self._images[-n_ctx:].astype(np.float32) / 255.0
        as_dev = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                           device=dev)
        images = as_dev(np.swapaxes(frames, 0, 1)[0])
        distribs = as_dev(np.swapaxes(self._make_input_distrib(0), 0, 1)[0])
        states = as_dev(np.asarray(state[-n_ctx:], np.float32))
        chosen = self._sampler.chosen_actions
        ctx_actions = as_dev(
            np.asarray(chosen[-(n_ctx - 1):], np.float32)
            if n_ctx > 1 and len(chosen) else
            np.zeros((n_ctx - 1, self._adim), np.float32))

        mean, sigma = initial_mean(spec, device=dev), \
            initial_sigma(spec, device=dev)
        K, M = self.elite_count, self._hp.num_samples
        for itr in range(self._n_iter):
            z = self._draw_normals(M, spec.nactions * spec.adim)
            plan = sample_actions(mean, sigma, spec, M, rejection_rounds=0,
                                  action_bound=self._hp.action_bound, z=z)
            full_actions = torch.cat(
                [ctx_actions[None].expand((M,) + ctx_actions.shape), plan],
                dim=1)
            scores = self._ensemble_cost(images, states, distribs,
                                         full_actions).cpu().numpy()
            self.plan_stat['scores_itr{}'.format(itr)] = scores
            self._best_indices = scores.argsort()[:K]
            self._best_actions = plan.cpu().numpy()[self._best_indices]
            if itr < self._n_iter - 1:
                mean, sigma = fit_elites(as_dev(self._best_actions), spec)
        self._t_since_replan = 0
