"""Classifier-cost CEM controller (PyTorch port).

Counterpart of ``visual_foresight_tpu/policy/cem_controllers/variants/
classifier_controller.py``: the last ``final_frames`` predicted frames of
camera 0 are scored by a success classifier (goal-conditioned or not), and
the cost is -mean(log sigmoid(logit)).  With ``use_fused_planner`` and
``GaussianCEMSampler`` (by class identity) the whole replan runs on the
device (``planners/cem.py`` with the classifier as its cost); any other
sampler, or ``use_fused_planner`` False, plans in the host CEM loop through
``TorchPredictor.__call__``.

The classifier is ``SuccessClassifier()`` at its default widths, restored
from ``classifier_path`` by ``models/convert.py::restore_network``: its
latest orbax ``step_<N>/``, as the JAX controller reads it, else its
``params.npz`` (seeded weights, with a warning, where it has neither).  The controller runs on ``device`` (a policy hparam,
``'cuda'`` by default).  The fused planner draws from a ``torch.Generator``
seeded from ``seed``, the samplers' host draws from a
``np.random.RandomState`` seeded from it.  Given a ``verbose_worker``, the
last iteration of every fused replan is dumped
(``planning_<t>_itr_<i>/plan.html``: the visualised elites' predicted
frames of camera 0 as GIFs and their scores), as the JAX package dumps it.
"""

from collections import OrderedDict

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.models.classifier import SuccessClassifier
from visual_foresight_torch.models.convert import restore_network
from visual_foresight_torch.planners import costs as cost_lib
from visual_foresight_torch.planners.cem import FusedCEMPlanner
from visual_foresight_torch.planners.gaussian import (initial_mean,
                                                      initial_sigma,
                                                      make_action_spec)
from visual_foresight_torch.prediction.predictor import TorchPredictor
from ..cem_base_controller import CEMBaseController
from ..samplers.gaussian_sampler import GaussianCEMSampler
from ..visualizer.construct_html import fill_template, save_gifs, save_html


class ClassifierController(CEMBaseController):
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
        self._images, self._goal_image = None, None
        self._verbose_worker = None
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(self._hp.seed))

        self._restore_scorer()

        self._fused = None
        if self._hp.use_fused_planner and \
                self._hp.sampler is GaussianCEMSampler:
            spec = make_action_spec(self._hp.values(), self._adim)
            if spec.nactions * spec.repeat != self._hp.T:
                raise ValueError('T must equal nactions*repeat')
            self._fused = FusedCEMPlanner(
                spec, self._hp.num_samples, iterations=self._hp.iterations,
                k_elite=self.elite_count,
                rejection_rounds=10 if self._hp.rejection_sampling else 0,
                action_bound=self._hp.action_bound,
                cost_fn=lambda gen_images, gen_distribs, ctx:
                self._frame_cost(gen_images, ctx),
                sample_chunk=self._hp.sample_chunk, device=self.device)

    def _restore_scorer(self):
        """The scoring network on the device, restored from its
        ``params.npz`` (``restored`` tells whether it was)."""
        self.classifier = SuccessClassifier(
            goal_conditioned=self._hp.goal_conditioned)
        self.classifier_restored = restore_network(self.classifier,
                                                   self._hp.classifier_path)
        self.classifier.to(self.device).eval()

    def _default_hparams(self):
        default_dict = {
            'predictor_class': TorchPredictor,
            'predictor_hparams': None,
            'model_path': '',
            'classifier_path': '',
            'goal_conditioned': True,
            'final_frames': 1,
            'vpred_batch_size': 200,
            'verbose_img_height': 128,
            'use_fused_planner': True,
            'seed': 0,
            'device': 'cuda',
        }
        parent_params = super()._default_hparams()
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    # ----------------------------------------------------------------- cost
    def _cost_context(self):
        """What ``_frame_cost`` reads besides the frames: the goal image of
        camera 0 on the device."""
        return torch.as_tensor(self._goal_tensor(), device=self.device)

    def _tail_frames(self, gen_images):
        """The last ``final_frames`` frames of camera 0, flattened:
        ((B * final_frames, H, W, 3) f32, B, final_frames)."""
        tail = gen_images[:, -self._hp.final_frames:, 0].float()
        b, tt = tail.shape[:2]
        return tail.reshape((b * tt,) + tail.shape[2:]), b, tt

    @torch.no_grad()
    def _frame_cost(self, gen_images, goal):
        """(B, T', ncam, H, W, 3) predicted frames -> (B,) costs:
        -mean(log sigmoid) of the classifier's logits."""
        flat, b, tt = self._tail_frames(gen_images)
        if self._hp.goal_conditioned:
            logits = self.classifier(flat, goal[None].expand(flat.shape))
        else:
            logits = self.classifier(flat)
        return cost_lib.classifier_logprob_cost(logits).reshape(b, tt).mean(
            dim=1)

    # ----------------------------------------------------------- the inputs
    def _context_tensors(self, state):
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
        return frames_cam, states, distrib_cam, ctx_actions

    def _goal_tensor(self):
        """(H, W, 3) goal image of camera 0 (zeros without a goal)."""
        goal = np.asarray(self._goal_image, np.float32) \
            if self._goal_image is not None else \
            np.zeros((self._n_cam, self._img_height, self._img_width, 3),
                     np.float32)
        if goal.ndim == 5:
            goal = goal[-1]
        return goal[0]

    # ------------------------------------------------------------ the paths
    def perform_CEM(self, state):
        if self._fused is None:
            return super().perform_CEM(state)
        frames_cam, states, distrib_cam, ctx_actions = \
            self._context_tensors(state)
        spec = self._fused.spec
        result = self._fused.replan(
            self.predictor.models, frames_cam, states, distrib_cam,
            ctx_actions, self._cost_context(),
            initial_mean(spec, device=self.device),
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
            folder = 'planning_{}_itr_{}'.format(self._t, self._n_iter - 1)
            content = OrderedDict()
            rows = [(gen_images[v, :, 0] * 255).astype(np.uint8)
                    for v in range(gen_images.shape[0])]
            content['pred'] = save_gifs(self._verbose_worker, folder, 'pred',
                                        rows)
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
        return self._frame_cost(
            torch.as_tensor(pred['predicted_frames'], device=self.device),
            self._cost_context()).cpu().numpy()

    def act(self, t=None, i_tr=None, images=None, goal_image=None, state=None,
            verbose_worker=None):
        self._images = images
        self._goal_image = goal_image
        self._verbose_worker = verbose_worker
        return super().act(t, i_tr, state)
