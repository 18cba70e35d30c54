"""Goal-image CEM controller (PyTorch port).

Counterpart of ``visual_foresight_tpu/policy/cem_controllers/
goal_im_controller.py``: cost = MSE between the final predicted frame(s) and
a goal image.  With ``use_fused_planner`` and ``GaussianCEMSampler`` (by
class identity) the whole replan runs on the device (``planners/cem.py``
with ``goal_image_mse`` as its cost); any other sampler, or
``use_fused_planner`` False, plans in the host CEM loop
(``CEMBaseController.perform_CEM``) through ``TorchPredictor.__call__``.

The controller runs on ``device`` (a policy hparam, ``'cuda'`` by default).
The fused planner draws from a ``torch.Generator`` seeded from ``seed``, the
samplers' host draws from a ``np.random.RandomState`` seeded from it.  Given
a ``verbose_worker``, the last iteration of every fused replan is dumped
(``planning_<t>_itr_<i>/plan.html``: the goal image, the visualised elites'
predicted frames as GIFs and their scores), as the JAX package dumps it.
"""

from collections import OrderedDict

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.planners import costs as cost_lib
from visual_foresight_torch.planners.cem import FusedCEMPlanner
from visual_foresight_torch.planners.gaussian import (initial_mean,
                                                      initial_sigma,
                                                      make_action_spec)
from visual_foresight_torch.prediction.predictor import TorchPredictor
from .cem_base_controller import CEMBaseController
from .samplers.gaussian_sampler import GaussianCEMSampler
from .visualizer.construct_html import (fill_template, save_gifs, save_html,
                                        save_img)


class GoalImController(CEMBaseController):
    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        CEMBaseController.__init__(self, ag_params, policyparams)
        self.device = resolve_device(self._hp.device, gpu_id)

        predictor_hparams = dict(self._hp.predictor_hparams or {})
        predictor_hparams.setdefault('designated_pixel_count', 1)
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

        self._img_height = ag_params['image_height']
        self._img_width = ag_params['image_width']
        self._n_cam = self.predictor.n_cam
        self._images = None
        self._goal_image = None
        self._verbose_worker = None
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(self._hp.seed))

        self._fused = None
        if self._hp.use_fused_planner and \
                self._hp.sampler is GaussianCEMSampler:
            spec = make_action_spec(self._hp.values(), self._adim)
            if spec.nactions * spec.repeat != self._hp.T:
                raise ValueError('T must equal nactions*repeat')
            final_frames = self._hp.final_frames

            def goal_cost(gen_images, gen_distribs, goal_image):
                return cost_lib.goal_image_mse(gen_images, goal_image,
                                               final_frames=final_frames)

            self._fused = FusedCEMPlanner(
                spec, self._hp.num_samples, iterations=self._hp.iterations,
                k_elite=self.elite_count,
                rejection_rounds=10 if self._hp.rejection_sampling else 0,
                action_bound=self._hp.action_bound, cost_fn=goal_cost,
                sample_chunk=self._hp.sample_chunk, device=self.device)

    def _default_hparams(self):
        default_dict = {
            'predictor_class': TorchPredictor,
            'predictor_hparams': None,
            'model_path': '',
            'vpred_batch_size': 200,
            'final_frames': 1,          # how many tail frames enter the MSE
            'verbose_img_height': 128,
            'state_append': None,
            'use_fused_planner': True,
            'seed': 0,
            'device': 'cuda',
        }
        parent_params = super()._default_hparams()
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    def _goal(self):
        """(ncam, H, W, 3) goal image on the device."""
        goal = np.asarray(self._goal_image, np.float32)
        if goal.ndim == 5:          # (1, ncam, H, W, 3)
            goal = goal[-1]
        return torch.as_tensor(goal, device=self.device)

    def perform_CEM(self, state):
        if self._fused is None:
            return super().perform_CEM(state)
        n_ctx = self._net_context
        frames = self._images[-n_ctx:].astype(np.float32) / 255.0
        frames_cam = np.swapaxes(frames, 0, 1)
        distrib_cam = np.zeros(
            (self._n_cam, n_ctx, self._img_height, self._img_width, 1),
            np.float32)
        states = np.asarray(state[-n_ctx:], np.float32)
        chosen = self._sampler.chosen_actions
        ctx_actions = np.asarray(chosen[-(n_ctx - 1):], np.float32) \
            if n_ctx > 1 and len(chosen) else \
            np.zeros((n_ctx - 1, self._adim), np.float32)

        spec = self._fused.spec
        result = self._fused.replan(
            self.predictor.models, frames_cam, states, distrib_cam,
            ctx_actions, self._goal(), initial_mean(spec, device=self.device),
            initial_sigma(spec, device=self.device),
            generator=self._generator)

        self._best_actions = result['best_actions'].cpu().numpy()
        scores_per_itr = result['scores_per_itr'].cpu().numpy()
        for itr in range(scores_per_itr.shape[0]):
            self.plan_stat['scores_itr{}'.format(itr)] = scores_per_itr[itr]
        self._best_indices = np.argsort(scores_per_itr[-1])[:self.elite_count]

        if self._verbose_condition(self._n_iter - 1) and \
                self._verbose_worker is not None:
            gen_images = result['vis']['gen_images'].cpu().numpy()
            goal = self._goal().cpu().numpy()
            folder = 'planning_{}_itr_{}'.format(self._t, self._n_iter - 1)
            content = OrderedDict()
            for c in range(self._n_cam):
                content['goal_cam{}'.format(c)] = [save_img(
                    self._verbose_worker, folder, 'goal_cam{}'.format(c),
                    (goal[c] * 255).astype(np.uint8))]
                rows = [(gen_images[v, :, c] * 255).astype(np.uint8)
                        for v in range(gen_images.shape[0])]
                content['cam_{}_pred'.format(c)] = save_gifs(
                    self._verbose_worker, folder, 'cam_{}_pred'.format(c), rows)
            content['scores'] = result['vis']['scores'].float().cpu().numpy()
            save_html(self._verbose_worker, '{}/plan.html'.format(folder),
                      fill_template(self._n_iter - 1, self._t, content))

        self._t_since_replan = 0

    def evaluate_rollouts(self, actions, cem_itr):
        n_ctx = self._net_context
        context = {
            'context_frames': self._images[-n_ctx:].astype(np.float32)[None]
            / 255.0,
            'context_actions': self._sampler.chosen_actions,
            'context_pixel_distributions': np.zeros(
                (1, n_ctx, self._n_cam, self._img_height, self._img_width, 1),
                np.float32),
            'context_states': np.asarray(self._state[-n_ctx:],
                                         np.float32)[None],
        }
        pred = self.predictor(context, {'actions': actions})
        return cost_lib.goal_image_mse(
            torch.as_tensor(pred['predicted_frames'], device=self.device),
            self._goal(), final_frames=self._hp.final_frames).cpu().numpy()

    def act(self, t=None, i_tr=None, images=None, goal_image=None, state=None,
            verbose_worker=None):
        self._images = images
        self._goal_image = goal_image
        self._verbose_worker = verbose_worker
        return super().act(t, i_tr, state)
