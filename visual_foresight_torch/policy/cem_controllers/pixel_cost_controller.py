"""Pixel-distance CEM controller (PyTorch port).

Counterpart of ``visual_foresight_tpu/policy/cem_controllers/
pixel_cost_controller.py``: the video predictor (``TorchPredictor``) plugged
into CEM, with cost = expected distance of the predicted designated-pixel
distribution to the goal pixel.  Two paths, chosen as the JAX package
chooses them:

* **fused**: the whole replan runs on the device (``planners/cem.py``) when
  ``use_fused_planner`` is set and the sampler is one of the five the
  device planner knows (matched by class identity): ``GaussianCEMSampler``
  with every one of its hparams (warm starts, ``rejection_sampling``,
  ``smooth_cov``, ``add_zero_action``, ``discrete_ind``,
  ``stochastic_planning`` with ``stochastic_penalty``, ``sample_chunk``),
  ``AutograspSampler`` (the grip latched on the device),
  ``AutograspEpsilon``, ``FoldingCEMSampler`` and ``CorrelatedNoiseSampler``
  (MPPI, anchored on the last executed action under
  ``smooth_across_last_action``);
* **host loop**: ``CEMBaseController.perform_CEM`` with the sampler's host
  draws, one ``TorchPredictor.__call__`` per CEM iteration; for any other
  sampler (a subclass of one of the five too) or ``use_fused_planner``
  False.

The controller runs on ``device`` (a policy hparam, ``'cuda'`` by default;
without a card it raises unless given ``'cpu'``).  The fused planner's draws
and the latents of a stochastic predictor come from a ``torch.Generator``
seeded from the ``seed`` hparam, the samplers' host draws from a
``np.random.RandomState`` seeded from it.

Given a ``verbose_worker`` (the benchmark agent's file worker), the last
CEM iteration of every fused replan is dumped as the JAX package dumps it:
``planning_<t>_itr_<i>/plan.html`` with the start frames, a GIF per
visualised elite of each designated pixel's predicted distribution (the
viridis colour map, ``visualizer/colormap.py``) and of the predicted
frames, and the elites' scores.  The rollouts come to the host once a dump.
"""

from collections import OrderedDict

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.planners import costs as cost_lib
from visual_foresight_torch.planners.cem import FusedCEMPlanner
from visual_foresight_torch.planners.gaussian import (ActionSpec,
                                                      initial_mean,
                                                      initial_sigma,
                                                      make_action_spec,
                                                      shift_sigma)
from visual_foresight_torch.prediction.predictor import TorchPredictor
from .cem_base_controller import CEMBaseController
from .samplers.autograsp_epsilon import AutograspEpsilon
from .samplers.autograsp_sampler import AutograspSampler
from .samplers.correlated_noise import CorrelatedNoiseSampler
from .samplers.folding_sampler import FoldingCEMSampler
from .samplers.gaussian_sampler import GaussianCEMSampler
from .visualizer.colormap import viridis
from .visualizer.construct_html import (fill_template, save_gifs, save_html,
                                        save_img)


class PixelCostController(CEMBaseController):
    """CEM over an action-conditioned video predictor with pixel-distance cost."""

    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        CEMBaseController.__init__(self, ag_params, policyparams)
        self.device = resolve_device(self._hp.device, gpu_id)

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
        self._verbose_worker = None
        self._chosen_distrib = None
        self._fused_state = None
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(self._hp.seed))
        self._fused = self._fused_planner() if self._hp.use_fused_planner \
            else None

    def _fused_planner(self):
        """The device planner for this policy's sampler, or None where the
        sampler runs in the host loop."""
        hp, adim = self._hp, self._adim
        common = dict(iterations=hp.iterations, k_elite=self.elite_count,
                      finalweight=hp.finalweight,
                      only_first_view=hp.only_take_first_view,
                      device=self.device)
        sampler = hp.sampler
        if sampler in (GaussianCEMSampler, AutograspSampler,
                       AutograspEpsilon):
            # autograsp: the spec covers the base dims, the grip command is
            # latched on the device as the last plan dim
            is_ag = sampler is AutograspSampler
            n_sampled = adim - 1 if is_ag else adim
            spec = make_action_spec(hp.values(), n_sampled)
            if spec.nactions * spec.repeat != hp.T:
                raise ValueError('T must equal nactions*repeat')
            # an action_order naming 'grasp' would sample the dim that the
            # latch derives
            if spec.adim != n_sampled:
                raise ValueError(
                    'action_order yields a {}-dim spec but the fused {} path '
                    'needs {} sampled dims'.format(
                        spec.adim, 'autograsp' if is_ag else 'gaussian',
                        n_sampled))
            ag_cfg = {
                'z_thresh': hp.z_thresh,
                'norm_factor': hp.action_norm_factor,
                'close_cmd': hp.gripper_close_cmd,
                'open_cmd': hp.gripper_open_cmd,
                'reopen': hp.reopen, 'deviation_prob': hp.deviation_prob,
                'no_refit': hp.no_refit} if is_ag else None
            ag_eps_cfg = None
            if sampler is AutograspEpsilon:
                # the dims as the host sampler finds them
                z_dim, grip_dim = 2, adim - 1
                for i, a in enumerate(hp.action_order or ()):
                    if a == 'grasp':
                        grip_dim = i
                    elif a == 'z':
                        z_dim = i
                ag_eps_cfg = {
                    'z_dim': z_dim, 'grip_dim': grip_dim,
                    'z_norm': hp.z_norm, 'zthresh': hp.ag_zthresh,
                    'epsilon': hp.ag_epsilon, 'base_frac': hp.base_frac,
                    'base_frac_reduce': hp.base_frac_reduce,
                    'repeat': spec.repeat, 'state_z_index': z_dim}
            # stochastic_planning=(K,): K latent copies of every unique plan
            stoch_k = int(hp.stochastic_planning[0]) \
                if hp.stochastic_planning else 1
            return FusedCEMPlanner(
                spec, hp.num_samples * stoch_k,
                rejection_rounds=10 if hp.rejection_sampling else 0,
                action_bound=hp.action_bound,
                blockdiag_refit=hp.cov_blockdiag, smooth_cov=hp.smooth_cov,
                add_zero_action=hp.add_zero_action, autograsp=ag_cfg,
                stochastic_k=stoch_k,
                discrete_dims=tuple(hp.discrete_ind or ()),
                ag_epsilon=ag_eps_cfg, sample_chunk=hp.sample_chunk,
                stochastic_penalty=hp.stochastic_penalty, **common)
        if sampler is FoldingCEMSampler:
            # the structured prior and its Gaussian rows sample on the
            # device; the refit is the plain elite mean and covariance
            spec = make_action_spec(hp.values(), adim)
            if spec.adim != 4:
                raise ValueError('the folding prior needs 4 base action dims')
            if spec.nactions * spec.repeat != hp.T:
                raise ValueError('T must equal nactions*repeat')
            return FusedCEMPlanner(
                spec, hp.num_samples, action_bound=False,
                folding={'split_frac': hp.split_frac,
                         'max_shift': tuple(hp.max_shift)}, **common)
        if sampler is CorrelatedNoiseSampler:
            stds = tuple(float(s) for s in hp.initial_std)
            spec = ActionSpec(
                adim=len(stds), nactions=hp.nactions, repeat=1,
                per_dim_std=stds, clip_dims_xy=(), clip_dims_rot=(),
                rej_dims_xy=(), rej_dims_lift=(), xy_std=stds[0],
                lift_std=stds[2] if len(stds) > 2 else stds[0])
            # the JAX package asserts this too: the RoboNet policies, which
            # leave T at 15 with 10 actions, plan in the host loop only
            if spec.nactions != hp.T:
                raise ValueError('CorrelatedNoise plans at control cadence: '
                                 'nactions ({}) must equal T ({})'.format(
                                     spec.nactions, hp.T))
            return FusedCEMPlanner(
                spec, hp.num_samples,
                mppi={'kappa': hp.kappa, 'beta_0': hp.beta_0,
                      'beta_1': hp.beta_1, 'refit_cov': hp.refit_cov,
                      'mean_bias': hp.mean_bias, 'per_dim_std': stds},
                **common)
        return None

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

    # ------------------------------------------------------------ fused path
    def _cost_grids(self):
        """Per-(cam, desig) distance grids for the pixel cost."""
        return cost_lib.distance_grid(
            self._goal_pix.reshape(self._n_cam, self._n_desig, 2),
            self._img_height, self._img_width, device=self.device)

    def _fused_sampling_state(self, chosen):
        """(mean, sigma, num_samples, anchor, anchor_valid) for this replan.

        Mirrors the host GaussianCEMSampler's warm-start semantics
        (reference ``samplers/gaussian_sampler.py:14-44``): with
        ``reuse_cov`` the previous replan's refit covariance is shifted one
        action block forward; with ``reuse_mean`` the mean warm-starts from
        the best plan's remaining actions; either warm start shrinks the
        sample count by ``reuse_factor``.  MPPI mode instead supplies the
        last executed action as the AR(1) anchor."""
        hp, dev = self._hp, self.device
        spec = self._fused.spec
        M = hp.num_samples
        # Gaussian and autograsp samplers only: the others lack the key
        stoch = hp.get('stochastic_planning')
        k = int(stoch[0]) if stoch else 1
        M *= k
        anchor = np.zeros(spec.adim, np.float32)
        anchor_valid = 0.0

        if self._fused.is_mppi:
            if hp.smooth_across_last_action and len(chosen):
                anchor = np.asarray(chosen[-1], np.float32)
                anchor_valid = 1.0
            return (initial_mean(spec, device=dev),
                    initial_sigma(spec, device=dev), M, anchor, anchor_valid)

        t = self._t
        warm_ok = t is not None and t >= spec.repeat - 1
        # .get: the folding hparams lack the Gaussian warm-start keys
        warm_cov = bool(hp.get('reuse_cov', 0)) and warm_ok and \
            self._fused_state is not None
        if warm_cov:
            sigma = shift_sigma(self._fused_state[1], spec,
                                float(hp.reuse_cov))
        else:
            sigma = initial_sigma(
                spec, reduce_std_dev=hp.get('reduce_std_dev', 1.0),
                reduce=t is not None and t >= 2, device=dev)

        plans = self._sampler.best_action_plans
        warm_mean = bool(hp.get('reuse_mean', False)) and warm_ok and \
            bool(plans) and plans[-1] is not None
        if warm_mean:
            # the remaining control-cadence actions, less a derived grip dim
            plan = np.asarray(plans[-1][0])[:, :spec.adim]
            short = plan.shape[0] % spec.repeat
            if short:
                plan = np.concatenate(
                    [plan, np.zeros((spec.repeat - short, spec.adim))], 0)
            per_block = plan.reshape(-1, spec.repeat, spec.adim)[:, 0]
            blocks = np.zeros((spec.nactions, spec.adim), np.float32)
            blocks[:per_block.shape[0]] = per_block[:spec.nactions]
            mean = torch.tensor(blocks.ravel(), device=dev)
        else:
            mean = initial_mean(spec, device=dev)

        if warm_cov or warm_mean:
            M = max(int(M * hp.reuse_factor), self.elite_count)
            M = ((M + k - 1) // k) * k      # keep K copies per unique plan
        return mean, sigma, M, anchor, anchor_valid

    def perform_CEM(self, state):
        if self._fused is None:
            return super().perform_CEM(state)

        self._logger.log('fused on-device CEM at t{}'.format(self._t))
        n_ctx = self._net_context

        # context tensors: (ncam, n_ctx, H, W, ...)
        frames = self._images[-n_ctx:].astype(np.float32) / 255.0
        frames_cam = np.swapaxes(frames, 0, 1)
        distrib_cam = np.swapaxes(self._make_input_distrib(0), 0, 1)
        states = np.asarray(state[-n_ctx:], np.float32)

        chosen = self._sampler.chosen_actions
        if len(chosen) >= n_ctx - 1:
            ctx_actions = np.asarray(chosen[-(n_ctx - 1):], np.float32) \
                if n_ctx > 1 else np.zeros((0, self._adim), np.float32)
        else:
            ctx_actions = np.zeros((n_ctx - 1, self._adim), np.float32)

        mean, sigma, num_samples, anchor, anchor_valid = \
            self._fused_sampling_state(chosen)
        result = self._fused.replan(
            self.predictor.models, frames_cam, states, distrib_cam,
            ctx_actions, self._cost_grids(), mean, sigma,
            generator=self._generator, num_samples=num_samples,
            anchor=anchor, anchor_valid=anchor_valid)
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

        if self._verbose_condition(self._n_iter - 1):
            self._dump_verbose(result)

        self._t_since_replan = 0

    def _dump_verbose(self, result):
        if self._verbose_worker is None:
            return
        vis = {k: result['vis'][k].float().cpu().numpy()
               for k in ('gen_images', 'gen_distribs', 'scores')}
        gen_images = vis['gen_images']          # (nv, T', ncam, H, W, C)
        gen_distribs = vis['gen_distribs']      # (nv, T', ncam, H, W, P)
        verbose_folder = 'planning_{}_itr_{}'.format(self._t, self._n_iter - 1)
        content_dict = OrderedDict()

        nv = gen_images.shape[0]
        for c in range(self._n_cam):
            name = 'cam_{}_start'.format(c)
            start_img = self._images[-1, c].copy()
            for p in range(self._n_desig):
                h, w = np.clip(self._desig_pix[c, p],
                               [0, 0], [self._img_height - 1,
                                        self._img_width - 1])
                start_img[int(h), int(w)] = [255, 0, 0]
                h, w = np.clip(self._goal_pix[c, p],
                               [0, 0], [self._img_height - 1,
                                        self._img_width - 1])
                start_img[int(h), int(w)] = [0, 0, 255]
            path = save_img(self._verbose_worker, verbose_folder, name,
                            start_img)
            content_dict[name] = [path for _ in range(nv)]

        for c in range(self._n_cam):
            for p in range(self._n_desig):
                # each frame scaled to its own peak, as the JAX dump does
                d = gen_distribs[:, :, c, :, :, p]
                d = d / (d.max(axis=(2, 3), keepdims=True) + 1e-6)
                rows = list(viridis(d))
                name = 'cam_{}_desig_{}'.format(c, p)
                content_dict[name] = save_gifs(self._verbose_worker,
                                               verbose_folder, name, rows)

        for c in range(self._n_cam):
            rows = [(gen_images[v, :, c] * 255).astype(np.uint8)
                    for v in range(nv)]
            name = 'cam_{}_pred_images'.format(c)
            content_dict[name] = save_gifs(self._verbose_worker,
                                           verbose_folder, name, rows)

        content_dict['scores'] = vis['scores']
        html = fill_template(self._n_iter - 1, self._t, content_dict,
                             img_height=self._hp.verbose_img_height)
        save_html(self._verbose_worker,
                  '{}/plan.html'.format(verbose_folder), html)

    # ------------------------------------------------------------ host loop
    def evaluate_rollouts(self, actions, cem_itr):
        context = {
            'context_frames': self._images[-self._net_context:]
            .astype(np.float32)[None] / 255.0,
            'context_actions': self._sampler.chosen_actions,
            'context_pixel_distributions':
                self._make_input_distrib(cem_itr)[None],
            'context_states': np.asarray(
                self._state[-self._net_context:], np.float32)[None],
        }
        prediction_dict = self.predictor(context, {'actions': actions})
        gen_images = prediction_dict['predicted_frames']
        gen_distrib = prediction_dict['predicted_pixel_distributions']
        return self._eval_pixel_cost(cem_itr, gen_distrib, gen_images)

    def _eval_pixel_cost(self, cem_itr, gen_distrib, gen_images):
        scores = cost_lib.expected_pixel_distance(
            torch.as_tensor(gen_distrib, device=self.device),
            self._cost_grids(), self._hp.finalweight, normalize=True,
            only_first_view=self._hp.only_take_first_view).cpu().numpy()
        if self._hp.predictor_propagation and \
                cem_itr == self._hp.iterations - 1:
            bestind = scores.argsort()[0]
            self._chosen_distrib = gen_distrib[bestind][-self._net_context:]
        return scores

    # --------------------------------------------------------------- helpers
    def _make_input_distrib(self, itr):
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
        # multi-object scenes hand over pixels for EVERY object; the policy
        # plans for the first n_desig of them (reference ntask semantics)
        self._desig_pix = np.array(desig_pix).reshape(
            (self._n_cam, -1, 2))[:, :self._n_desig]
        self._goal_pix = np.array(goal_pix).reshape(
            (self._n_cam, -1, 2))[:, :self._n_desig]
        self._images = images
        self._verbose_worker = verbose_worker
        return super().act(t, i_tr, state)
