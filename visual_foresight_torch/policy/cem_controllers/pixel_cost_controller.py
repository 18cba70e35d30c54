"""Pixel-distance CEM controller (PyTorch port).

Counterpart of ``visual_foresight_tpu/policy/cem_controllers/
pixel_cost_controller.py`` on its fused Gaussian path: the video predictor
(``TorchPredictor``) plugged into the device-side CEM replan
(``planners/cem.py``), with cost = expected distance of the predicted
designated-pixel distribution to the goal pixel.  Warm starts
(``reuse_mean``/``reuse_cov``, with the sample count shrunk by
``reuse_factor``), ``predictor_propagation`` and every Gaussian sampler
hparam (``rejection_sampling``, ``smooth_cov``, ``add_zero_action``,
``discrete_ind``, ``stochastic_planning`` with ``stochastic_penalty``,
``sample_chunk``) are ported.

The controller runs on ``device`` (a policy hparam, ``'cuda'`` by default;
without a card it raises unless given ``'cpu'``).  Its plan noise and the
latents of a stochastic predictor come from a ``torch.Generator`` seeded
from the ``seed`` hparam.  Not ported, each
raising ``NotImplementedError``: samplers other than ``GaussianCEMSampler``,
the host CEM loop (``use_fused_planner=False``), the verbose HTML dump (a
``verbose_worker``).
"""

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.planners import costs as cost_lib
from visual_foresight_torch.planners.cem import FusedCEMPlanner
from visual_foresight_torch.planners.gaussian import (initial_mean,
                                                      initial_sigma,
                                                      make_action_spec,
                                                      shift_sigma)
from visual_foresight_torch.prediction.predictor import TorchPredictor
from .cem_base_controller import CEMBaseController
from .samplers.gaussian_sampler import GaussianCEMSampler


class PixelCostController(CEMBaseController):
    """CEM over an action-conditioned video predictor with pixel-distance cost."""

    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        CEMBaseController.__init__(self, ag_params, policyparams)
        if self._hp.sampler is not GaussianCEMSampler:
            raise NotImplementedError('sampler {} is not ported'.format(
                self._hp.sampler.__name__))
        if not self._hp.use_fused_planner:
            raise NotImplementedError('the host CEM loop '
                                      '(use_fused_planner=False) is not ported')
        self.device = resolve_device(self._hp.device)

        predictor_hparams = dict(self._hp.predictor_hparams or {})
        predictor_hparams.setdefault('designated_pixel_count',
                                     self._hp.designated_pixel_count)
        predictor_hparams.setdefault(
            'run_batch_size',
            min(self._hp.vpred_batch_size, self._hp.num_samples))
        predictor_hparams.setdefault('ncam', ag_params.get('ncam', 1))
        predictor_hparams.setdefault(
            'img_dims', (ag_params['image_height'], ag_params['image_width']))
        predictor_hparams.setdefault('adim', ag_params['adim'])
        predictor_hparams.setdefault('sdim', ag_params['sdim'])
        predictor_hparams.setdefault('sequence_length', self._hp.T + 2)

        self.predictor = self._hp.predictor_class(
            self._hp.model_path, predictor_hparams, device=self.device)
        self.predictor.restore()

        self._net_context = self.predictor.n_context
        if self._hp.start_planning < self._net_context - 1:
            self._hp.start_planning = self._net_context - 1

        self._n_desig = self._hp.designated_pixel_count
        self._img_height = ag_params['image_height']
        self._img_width = ag_params['image_width']
        self._n_cam = self.predictor.n_cam

        self._desig_pix = None
        self._goal_pix = None
        self._images = None
        self._chosen_distrib = None
        self._fused_state = None
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(self._hp.seed))

        spec = make_action_spec(self._hp.values(), self._adim)
        assert spec.nactions * spec.repeat == self._hp.T, \
            'T must equal nactions*repeat'
        assert spec.adim == self._adim, \
            ('action_order yields a {}-dim spec but the fused gaussian path '
             'needs {} sampled dims'.format(spec.adim, self._adim))
        # stochastic_planning=(K,): K latent copies of every unique plan
        stoch_k = self._stoch_k = int(self._hp.stochastic_planning[0]) \
            if self._hp.stochastic_planning else 1
        self._fused = FusedCEMPlanner(
            spec, self._hp.num_samples * stoch_k,
            iterations=self._hp.iterations, k_elite=self.elite_count,
            finalweight=self._hp.finalweight,
            rejection_rounds=10 if self._hp.rejection_sampling else 0,
            action_bound=self._hp.action_bound,
            only_first_view=self._hp.only_take_first_view,
            blockdiag_refit=self._hp.cov_blockdiag,
            smooth_cov=self._hp.smooth_cov,
            add_zero_action=self._hp.add_zero_action,
            stochastic_k=stoch_k,
            discrete_dims=tuple(self._hp.discrete_ind or ()),
            sample_chunk=self._hp.sample_chunk,
            stochastic_penalty=self._hp.stochastic_penalty,
            device=self.device)

    def _default_hparams(self):
        default_dict = {
            'predictor_class': TorchPredictor,
            'predictor_hparams': None,
            'model_path': '',
            'vpred_batch_size': 200,
            'designated_pixel_count': 1,
            'verbose_img_height': 128,
            'predictor_propagation': False,
            'only_take_first_view': False,
            'state_append': None,
            'finalweight': 10.,
            'use_fused_planner': True,
            'seed': 0,
            'device': 'cuda',
        }
        parent_params = super()._default_hparams()
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    def reset(self):
        super().reset()
        self._chosen_distrib = None
        self._fused_state = None

    def _cost_grids(self):
        """Per-(cam, desig) distance grids for the fused cost."""
        return cost_lib.distance_grid(
            self._goal_pix.reshape(self._n_cam, self._n_desig, 2),
            self._img_height, self._img_width, device=self.device)

    def _fused_sampling_state(self):
        """(mean, sigma, num_samples) for this replan.

        Mirrors the host GaussianCEMSampler's warm-start semantics
        (reference ``samplers/gaussian_sampler.py:14-44``): with
        ``reuse_cov`` the previous replan's refit covariance is shifted one
        action block forward; with ``reuse_mean`` the mean warm-starts from
        the best plan's remaining actions; either warm start shrinks the
        sample count by ``reuse_factor``."""
        hp = self._hp
        spec = self._fused.spec
        M = hp.num_samples * self._stoch_k
        t = self._t
        warm_ok = t is not None and t >= spec.repeat - 1
        warm_cov = bool(hp.reuse_cov) and warm_ok and \
            self._fused_state is not None
        if warm_cov:
            sigma = shift_sigma(self._fused_state[1], spec,
                                float(hp.reuse_cov))
        else:
            sigma = initial_sigma(spec, reduce_std_dev=hp.reduce_std_dev,
                                  reduce=t is not None and t >= 2,
                                  device=self.device)

        plans = self._sampler.best_action_plans
        warm_mean = bool(hp.reuse_mean) and warm_ok and bool(plans) and \
            plans[-1] is not None
        if warm_mean:
            plan = np.asarray(plans[-1][0])       # remaining control-cadence
            short = plan.shape[0] % spec.repeat
            if short:
                plan = np.concatenate(
                    [plan, np.zeros((spec.repeat - short, spec.adim))], 0)
            per_block = plan.reshape(-1, spec.repeat, spec.adim)[:, 0]
            blocks = np.zeros((spec.nactions, spec.adim), np.float32)
            blocks[:per_block.shape[0]] = per_block[:spec.nactions]
            mean = torch.tensor(blocks.ravel(), device=self.device)
        else:
            mean = initial_mean(spec, device=self.device)

        if warm_cov or warm_mean:
            M = max(int(M * hp.reuse_factor), self.elite_count)
            k = self._stoch_k       # keep K copies per unique plan
            M = ((M + k - 1) // k) * k
        return mean, sigma, M

    def perform_CEM(self, state):
        self._logger.log('fused on-device CEM at t{}'.format(self._t))
        n_ctx = self._net_context

        # context tensors: (ncam, n_ctx, H, W, ...)
        frames = self._images[-n_ctx:].astype(np.float32) / 255.0
        frames_cam = np.swapaxes(frames, 0, 1)
        distrib_cam = np.swapaxes(self._make_input_distrib(), 0, 1)
        states = np.asarray(state[-n_ctx:], np.float32)

        chosen = self._sampler.chosen_actions
        if len(chosen) >= n_ctx - 1:
            ctx_actions = np.asarray(chosen[-(n_ctx - 1):], np.float32) \
                if n_ctx > 1 else np.zeros((0, self._adim), np.float32)
        else:
            ctx_actions = np.zeros((n_ctx - 1, self._adim), np.float32)

        mean, sigma, num_samples = self._fused_sampling_state()
        result = self._fused.replan(
            self.predictor.models, frames_cam, states, distrib_cam,
            ctx_actions, self._cost_grids(), mean, sigma,
            generator=self._generator, num_samples=num_samples)
        # refit distribution feeds the next replan's reuse_mean/reuse_cov
        self._fused_state = (result['mean'], result['sigma'])

        self._best_actions = result['best_actions'].cpu().numpy()
        scores_per_itr = result['scores_per_itr'].cpu().numpy()
        for itr in range(scores_per_itr.shape[0]):
            self.plan_stat['scores_itr{}'.format(itr)] = scores_per_itr[itr]
        self._best_indices = np.argsort(scores_per_itr[-1])[:self.elite_count]

        if self._hp.predictor_propagation:
            # reuse the best predicted distribution as the next context:
            # gen_distribs[0] is (T', ncam, H, W, P) -> context (n_ctx, ncam, ...)
            best_distrib = result['vis']['gen_distribs'][0].cpu().numpy()
            self._chosen_distrib = best_distrib[-n_ctx:]

        self._t_since_replan = 0

    def _make_input_distrib(self):
        if self._hp.predictor_propagation and self._chosen_distrib is not None:
            return self._chosen_distrib[-self._net_context:]
        return self._switch_on_pix(self._desig_pix)

    def _switch_on_pix(self, desig):
        """One-hot pixel distributions at the designated pixels
        (reference ``_switch_on_pix``, ``pixel_cost_controller.py:206-215``)."""
        one_hot = np.zeros((self._net_context, self._n_cam, self._img_height,
                            self._img_width, self._n_desig), dtype=np.float32)
        desig = np.clip(
            desig, np.zeros(2), np.array([self._img_height,
                                          self._img_width]) - 1).astype(np.int64)
        for icam in range(self._n_cam):
            for p in range(self._n_desig):
                one_hot[:, icam, desig[icam, p, 0], desig[icam, p, 1], p] = 1.0
        return one_hot

    def act(self, t=None, i_tr=None, desig_pix=None, goal_pix=None,
            images=None, state=None, verbose_worker=None):
        if verbose_worker is not None:
            raise NotImplementedError('the verbose plan dump is not ported')
        # multi-object scenes hand over pixels for EVERY object; the policy
        # plans for the first n_desig of them (reference ntask semantics)
        self._desig_pix = np.array(desig_pix).reshape(
            (self._n_cam, -1, 2))[:, :self._n_desig]
        self._goal_pix = np.array(goal_pix).reshape(
            (self._n_cam, -1, 2))[:, :self._n_desig]
        self._images = images
        return super().act(t, i_tr, state)
