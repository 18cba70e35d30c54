"""Human-in-the-loop CEM (reference ``human_cem_controller.py``).

The predictor renders candidate rollouts to an HTML page; a human types a
score per trajectory, which drives the CEM refit.  Mostly a debugging /
dataset-curation tool.

The port's own copy of ``visual_foresight_tpu/policy/cem_controllers/
human_cem_controller.py``: the predictor runs on the controller's
``device`` through the host CEM loop (``TorchPredictor.__call__``), the
scores are read with ``input()``, and the act needs a ``verbose_worker``
(the pages and GIFs go through it).
"""

from collections import OrderedDict

import numpy as np

from .pixel_cost_controller import PixelCostController
from .visualizer.construct_html import (fill_template, save_gifs, save_html,
                                        save_img)


class HumanCEMController(PixelCostController):
    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        pp = dict(policyparams)
        pp['use_fused_planner'] = False   # scoring is human, not on-device
        super().__init__(ag_params, pp, gpu_id, ngpu)
        self._save_actions = None

    def reset(self):
        super().reset()
        self._save_actions = None

    def evaluate_rollouts(self, actions, cem_itr):
        context = {
            'context_frames': self._images[-self._net_context:]
            .astype(np.float32)[None] / 255.0,
            'context_actions': self._sampler.chosen_actions,
            'context_pixel_distributions': self._make_input_distrib(cem_itr)[None],
            'context_states': np.asarray(
                self._state[-self._net_context:], np.float32)[None],
        }
        gen_images = self.predictor(
            context, {'actions': actions})['predicted_frames']

        verbose_folder = 'planning_{}_itr_{}'.format(self._t, cem_itr)
        content_dict = OrderedDict()
        for c in range(self._n_cam):
            name = 'cam_{}_start'.format(c)
            path = save_img(self._verbose_worker, verbose_folder, name,
                            self._images[-1, c])
            content_dict[name] = [path] * gen_images.shape[0]
            rows = [(gen_images[i, :, c] * 255).astype(np.uint8)
                    for i in range(gen_images.shape[0])]
            content_dict['cam_{}_pred_images'.format(c)] = save_gifs(
                self._verbose_worker, verbose_folder,
                'cam_{}_pred_images'.format(c), rows)
        save_html(self._verbose_worker, '{}/preds.html'.format(verbose_folder),
                  fill_template(cem_itr, self._t, content_dict,
                                img_height=self._hp.verbose_img_height))

        scores = np.zeros(gen_images.shape[0])
        for i in range(gen_images.shape[0]):
            scores[i] = float(input('Score for traj {}: '.format(i)))

        content_dict['scores'] = scores
        save_html(self._verbose_worker, '{}/plan.html'.format(verbose_folder),
                  fill_template(cem_itr, self._t, content_dict,
                                img_height=self._hp.verbose_img_height))
        return scores

    def act(self, t=None, i_tr=None, images=None, state=None,
            verbose_worker=None, desig_pix=None, goal_pix=None):
        if t <= 0 and 'y' == input('restore traj? (y/n): '):
            import pickle as pkl
            with open(input('path: '), 'rb') as f:
                self._save_actions = pkl.load(f)
        if self._save_actions is not None and t < len(self._save_actions):
            return {'actions': self._save_actions[t]['actions']}

        h, w = self._img_height, self._img_width
        dp = desig_pix if desig_pix is not None else \
            np.zeros((self._n_cam, self._n_desig, 2))
        gp = goal_pix if goal_pix is not None else \
            np.tile([[h - 1, w - 1]], (self._n_cam, self._n_desig, 1))
        self._images = images
        self._verbose_worker = verbose_worker
        return super().act(t, i_tr, dp, gp, images, state, verbose_worker)
