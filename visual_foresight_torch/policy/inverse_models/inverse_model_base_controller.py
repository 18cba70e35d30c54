"""Inverse-model (non-CEM) controller (PyTorch port).

Counterpart of ``visual_foresight_tpu/policy/inverse_models/
inverse_model_base_controller.py``: an inverse model maps (current image,
goal image, context) to an action plan, and the controller replans every
``replan_every`` steps.  The default predictor is :class:`TorchInverseModel`
(``models/inverse.py``); any object with the contract
``predictor(current, goal, context_actions, context_frames) -> (1, T,
adim)`` can be given as ``predictor_class``.  It is built with a ``device``
argument (the ``device`` hparam, ``'cuda'`` by default).  The default
model's weights come from its path through
``models/convert.py::restore_network``: its latest orbax ``step_<N>/``, as
the JAX controller reads it, else its ``params.npz``, else seeded weights
with a warning.  The warm-up
actions before ``num_context`` come from the global ``np.random``, as in
the JAX package.
"""

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.models.convert import restore_network
from visual_foresight_torch.models.inverse import InverseNet
from visual_foresight_torch.policy.policy import Policy
from visual_foresight_torch.utils.logger import Logger


def convert_to_float(x):
    assert x.dtype == np.uint8, 'expected uint8 input'
    return x.astype(np.float32) / 255.0


class TorchInverseModel:
    """The inverse model on ``device``: ``InverseNet`` restored from
    ``model_params_path`` (its latest ``step_<N>/``, else its
    ``params.npz``), or seeded weights with a warning (``restored`` tells
    which)."""

    def __init__(self, model_params_path, hparams=None, n_gpus=1, first_gpu=0,
                 device='cuda'):
        hp = {'adim': 4, 'plan_T': 7, 'num_context': 2}
        hp.update(hparams or {})
        self._hp = hp
        self._path = model_params_path
        self.device = resolve_device(device, first_gpu)
        self.net = InverseNet(hp['adim'], hp['plan_T'], hp['num_context'])
        self.restored = False

    def restore(self):
        self.restored = restore_network(self.net, self._path)
        self.net.to(self.device).eval()
        return self

    @torch.no_grad()
    def __call__(self, current, goal, context_actions, context_frames):
        as_dev = lambda x: torch.as_tensor(
            np.ascontiguousarray(x, np.float32), device=self.device)
        out = self.net(as_dev(current)[None], as_dev(goal)[None],
                       as_dev(context_frames))
        return out.cpu().numpy()


class InvModelBaseController(Policy):
    """Inverse model policy."""

    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        self._hp = self._default_hparams()
        self._override_defaults(policyparams)
        self.agentparams = ag_params

        if self._hp.logging_dir:
            self._logger = Logger(self._hp.logging_dir, 'invmodel_log.txt')
        else:
            self._logger = Logger(printout=True)
        self._logger.log('init inverse model controller')

        self._adim = self.agentparams['adim']
        self._sdim = self.agentparams['sdim']

        predictor_hparams = {'adim': self._adim, 'plan_T': self._hp.load_T,
                             'num_context': self._hp.num_context,
                             'img_dims': (ag_params['image_height'],
                                          ag_params['image_width'])}
        self.predictor = self._hp.predictor_class(
            self._hp.model_params_path, predictor_hparams, n_gpus=ngpu,
            first_gpu=gpu_id, device=self._hp.device)
        self.predictor.restore()

        self.action_counter = 0
        self.actions = None
        self.context_actions = [None] * self._hp.num_context
        self.context_frames = [None] * self._hp.num_context

    def _default_hparams(self):
        default_dict = {
            'T': 15,
            'predictor_class': TorchInverseModel,
            'model_params_path': '',
            'model_restore_path': '',
            'logging_dir': '',
            'load_T': 7,
            'num_context': 2,
            'replan_every': 2,
            'context_action_weight': [1, 1, 1, 1],
            'initial_action_low': [-0.025, -0.025, -0.025, 0],
            'initial_action_high': [0.025, 0.025, 0.025, 0],
            'device': 'cuda',
        }
        parent_params = super()._default_hparams()
        for k, v in default_dict.items():
            parent_params.add_hparam(k, v)
        return parent_params

    def reset(self):
        self.plan_stat = {}
        self.action_counter = 0
        self.actions = None
        self.context_actions = [None] * self._hp.num_context
        self.context_frames = [None] * self._hp.num_context

    def _sample_initial_action(self):
        return np.random.uniform(self._hp.initial_action_low,
                                 self._hp.initial_action_high)

    def act(self, t=None, i_tr=None, images=None, goal_image=None):
        if t < self._hp.num_context:
            action = self._sample_initial_action() * \
                np.asarray(self._hp.context_action_weight)[:self._adim]
        else:
            if (t - self._hp.num_context) % self._hp.replan_every == 0:
                float_ctx = [frame[None, None] for frame in self.context_frames]
                prepped_ctx_im = np.concatenate(float_ctx, axis=1)
                prepped_ctx_act = np.array(self.context_actions)[None]
                goal = goal_image[-1, 0]
                if goal.dtype == np.uint8:
                    goal = convert_to_float(goal)
                self.actions = self.predictor(
                    convert_to_float(images[-1, 0]), goal,
                    prepped_ctx_act, prepped_ctx_im)
                self.action_counter = 0
            assert self.actions.shape[1] > self.action_counter, \
                'ran past plan length - replan more often'
            action = self.actions[0, self.action_counter]
            self.action_counter += 1

        new_context_image = convert_to_float(np.copy(images[-1, 0]))
        self.update_context(new_context_image, action)
        return {'actions': action, 'plan_stat': self.plan_stat}

    def update_context(self, new_image, new_action):
        self.context_frames.append(new_image)
        self.context_actions.append(new_action)
        if len(self.context_frames) > self._hp.num_context:
            self.context_frames.pop(0)
            self.context_actions.pop(0)
