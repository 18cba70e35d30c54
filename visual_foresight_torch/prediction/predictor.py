"""Predictor serving layer (PyTorch).

Counterpart of ``visual_foresight_tpu/prediction/predictor.py``::

    predictor = TorchPredictor(model_path, {'designated_pixel_count': 1, ...})
    predictor.restore()
    out = predictor({'context_frames': ..., 'context_actions': ...,
                     'context_pixel_distributions': ...,
                     'context_states': ...}, {'actions': actions})
    out['predicted_frames']                # (M, T', ncam, H, W, 3) float32
    out['predicted_pixel_distributions']   # (M, T', ncam, H, W, P)

One ``CDNAPredictor`` module per camera lives in ``predictor.models``; it
is any architecture ``TPUPredictor`` builds (the classic backbone by
default, the space-to-depth one, DNA, ``fuse_decode``; ``s2d_tail`` is taken
and runs the full-resolution tail), as the hparams and the checkpoint's
``model_config.json`` say.  Weights come from each ``view<c>/`` directory,
in the JAX package's order: its highest-step TF1 TensorBundle
(``model-<N>.index`` and its data shards, imported through ``tf1_import``),
else its highest ``step_<N>/`` orbax checkpoint (read with numpy alone by
``prediction/checkpoints.py``), else the port's numpy parameter file
(``params.npz``: the flax tree flattened with '/'-joined keys), else a
seeded initialization.
"""

import copy
import glob
import json
import os
import warnings

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.models.convert import (PARAMS_FILE,
                                                   load_flax_params,
                                                   params_to_flax, read_npz,
                                                   seeded_state,
                                                   unflatten_flax)
from visual_foresight_torch.prediction import checkpoints, tf1_import
# seed of the latent draw when ``__call__`` is given neither a generator nor
# a latent (the JAX package then uses ``PRNGKey(0)``; the two streams differ)
DEFAULT_LATENT_SEED = 0

DEFAULT_HPARAMS = {
    'designated_pixel_count': 1,
    'run_batch_size': 200,
    'sequence_length': 15,
    'context_frames': 2,
    'ncam': 1,
    'img_dims': (48, 64),
    'adim': 3,
    'sdim': 3,
    'num_masks': 10,
    'kernel_size': 5,
    'sna': True,
    'dna': False,
    'latent_dim': 0,
    'dtype': 'bfloat16',
    'separable_lstm': True,
    'lstm_kernel': 5,
    'std_factor': 0,
    'enc_features': (32, 64, 128),
    'renorm_distribs': False,
    # the port's tail is always the CUDA kernel on the card; the TPU
    # package's switch between its Pallas and XLA tails has no meaning here
    'use_pallas_warp': False,
    # the TPU package's plan-mode step in a block layout for its lanes; the
    # port takes it and runs the full-resolution tail kernel all the same
    's2d_tail': False,
    # the port's time loop is a Python loop, so there is nothing to unroll
    'scan_unroll': 1,
    # std-backbone mask softmax placement (identical arithmetic either way).
    # The TPU package serves 'fullres'; here 'lowres' is the serving default:
    # the tail kernel reads the masks as the low-resolution head leaves them,
    # so this placement runs no depth_to_space copy at all
    'mask_softmax': 'lowres',
    # opt-in, as in JAX: dec1, depth_to_space and dec1_gates composed into
    # one product (the weights composed once a rollout)
    'fuse_decode': False,
}

_ARCH_KEYS = ('context_frames', 'num_masks', 'kernel_size', 'sna', 'dna',
              'latent_dim', 'lstm_kernel', 'separable_lstm', 'adim', 'sdim',
              'std_factor', 'enc_features')


class TorchPredictor:
    """Serves the action-conditioned video predictor on one device."""

    def __init__(self, model_path, hparams=None, device='cuda'):
        if isinstance(model_path, (list, tuple)) and model_path:
            model_path = model_path[0]
        self._model_path = model_path
        hp = dict(DEFAULT_HPARAMS)
        hp.update(hparams or {})
        self._hp = hp
        self.device = resolve_device(device)
        self.models = None
        self.restored = False
        # adopt the checkpoint's architecture before the one build; without
        # a model_config.json the defaults build the classic backbone
        self._adopt_model_config()
        self._build_model()

    @property
    def n_context(self):
        return self._hp['context_frames']

    @property
    def n_cam(self):
        return self._hp['ncam']

    @property
    def dtype(self):
        return torch.bfloat16 if self._hp['dtype'] == 'bfloat16' \
            else torch.float32

    def _build_model(self):
        hp = self._hp
        self.model = CDNAPredictor(
            tuple(hp['img_dims']), n_context=hp['context_frames'],
            num_masks=hp['num_masks'], kernel_size=hp['kernel_size'],
            sna=hp['sna'], dna=hp['dna'],
            num_distribs=hp['designated_pixel_count'],
            sdim=hp['sdim'], adim=hp['adim'], dtype=self.dtype,
            enc_features=tuple(hp['enc_features']),
            lstm_kernel=hp['lstm_kernel'],
            separable_lstm=hp['separable_lstm'],
            std_factor=hp['std_factor'],
            renorm_distribs=hp['renorm_distribs'],
            mask_softmax=hp['mask_softmax'],
            latent_dim=hp['latent_dim'],
            fuse_decode=hp['fuse_decode']).to(self.device).eval()

    def _adopt_model_config(self):
        """Adopt the architecture recorded in ``model_config.json`` next to
        the checkpoints, as ``TPUPredictor.restore`` does."""
        cfg_path = os.path.join(str(self._model_path), 'model_config.json')
        if not os.path.isfile(cfg_path):
            return
        with open(cfg_path) as f:
            cfg = json.load(f)
        if 'enc_features' in cfg:
            cfg['enc_features'] = tuple(cfg['enc_features'])
        self._hp['enc_features'] = tuple(self._hp['enc_features'])
        changed = {k: cfg[k] for k in _ARCH_KEYS
                   if k in cfg and cfg[k] != self._hp[k]}
        if not changed:
            return
        print('predictor: adopting model config from checkpoint dir '
              '({})'.format(changed))
        self._hp.update(changed)

    def init_params(self, seed=0):
        """Seeded full-width weights (``models/convert.py::seeded_state``)."""
        return seeded_state(self.model, seed)

    def set_params(self, params_per_cam):
        """One ``state_dict`` per camera."""
        models = []
        for c, state in enumerate(params_per_cam):
            model = self.model if c == 0 else copy.deepcopy(self.model)
            model.load_state_dict(state)
            models.append(model)
        self.models = models
        return self

    def restore(self):
        """Load each camera's weights from ``view<c>/`` (``load_view``: its
        latest TF1 bundle, else its latest ``step_<N>/``, else its
        ``params.npz``); where a view has none, warn and use weights seeded
        with the camera index (``restored`` turns False), as
        ``TPUPredictor.restore`` does.  A bundle, step directory or file
        that does not load raises.  The architecture in
        ``model_config.json`` was adopted when the predictor was built."""
        states = []
        self.restored = True
        for c in range(self.n_cam):
            view_dir = os.path.join(str(self._model_path), 'view{}'.format(c))
            if load_view(self.model, view_dir) is not None:
                states.append({k: v.clone() for k, v in
                               self.model.state_dict().items()})
            else:
                warnings.warn('no TF1 bundle, checkpoint or numpy params in '
                              '{}; using seeded random weights'.format(
                                  view_dir))
                states.append(self.init_params(seed=c))
                self.restored = False
        return self.set_params(states)

    # -- reference calling convention ---------------------------------------
    @torch.no_grad()
    def __call__(self, context, action_dict, generator=None, latent=None):
        """
        :param context: dict with 'context_frames' (n_ctx, ncam, H, W, 3)
            float [0,1] (or (1, n_ctx, ncam, ...)), 'context_actions'
            (>= n_ctx-1, adim), 'context_states' (n_ctx, sdim) and
            'context_pixel_distributions' (n_ctx, ncam, H, W, P)
        :param action_dict: {'actions': (M, T_plan, adim)} candidate plans
        :param generator: ``torch.Generator`` on the predictor's device for
            the latent of a stochastic model (``latent_dim`` > 0); without
            one, a generator seeded with ``DEFAULT_LATENT_SEED`` is used
        :param latent: (M, latent_dim) latent given outright
        :return: dict of numpy arrays 'predicted_frames'
            (M, T', ncam, H, W, 3) and 'predicted_pixel_distributions'
            (M, T', ncam, H, W, P), T' = T_plan

        As in the JAX package, this runs the model's teacher-forced forward
        over the context actions followed by the plan, so one latent per
        sample, shared by the cameras, conditions the context steps too (the
        fused planner's ``encode_context`` conditions them on zeros).
        """
        if self.models is None:
            raise RuntimeError('call restore() first')
        n_ctx = self.n_context
        frames = np.asarray(context['context_frames'], np.float32)
        if frames.ndim == 6:
            frames = frames[0]
        distribs = np.asarray(context['context_pixel_distributions'],
                              np.float32)
        if distribs.ndim == 6:
            distribs = distribs[0]
        states = np.asarray(context['context_states'], np.float32)
        if states.ndim == 3:
            states = states[0]
        states = states[-n_ctx:]
        chosen = np.asarray(context.get(
            'context_actions', np.zeros((n_ctx - 1, self._hp['adim']))),
            np.float32)
        ctx_actions = chosen[-(n_ctx - 1):] if n_ctx > 1 else chosen[:0]
        frames_cam = np.swapaxes(frames[-n_ctx:], 0, 1)
        distribs_cam = np.swapaxes(distribs[-n_ctx:], 0, 1)
        actions = np.asarray(action_dict['actions'], np.float32)
        M = actions.shape[0]
        full_actions = np.concatenate(
            [np.tile(ctx_actions[None], (M, 1, 1)), actions], axis=1)

        dev = lambda x: torch.as_tensor(x, device=self.device)
        if self._hp['latent_dim'] and latent is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(
                    DEFAULT_LATENT_SEED)
            latent = torch.randn((M, self._hp['latent_dim']),
                                 generator=generator, device=self.device)
        elif latent is not None:
            latent = dev(np.asarray(latent, np.float32)) \
                if not isinstance(latent, torch.Tensor) else latent
        tile = lambda x: dev(x)[None].expand((M,) + x.shape)
        gen_i, gen_d = [], []
        for c, model in enumerate(self.models):
            out = model(tile(frames_cam[c]), dev(full_actions), tile(states),
                        tile(distribs_cam[c]), latent=latent)
            gen_i.append(out['gen_images'][:, n_ctx - 1:])
            gen_d.append(out['gen_distribs'][:, n_ctx - 1:])
        return {
            'predicted_frames': _to_host(torch.stack(gen_i, dim=2)),
            'predicted_pixel_distributions':
                _to_host(torch.stack(gen_d, dim=2)),
        }


def latest_tf1_prefix(view_dir):
    """Highest-step TF1 bundle prefix (``model-<N>.index``) in
    ``view_dir``, or None: the reference's latest-iteration glob applied to
    TF1 checkpoints (``setup_predictor.py:12-28``), as
    ``TPUPredictor._latest_tf1_prefix``."""
    best, best_step = None, -1
    for idx in glob.glob(os.path.join(view_dir, '*.index')):
        prefix = idx[:-len('.index')]
        digits = ''.join(ch for ch in prefix.rsplit('-', 1)[-1]
                         if ch.isdigit())
        step = int(digits) if digits else 0
        if step > best_step:
            best, best_step = prefix, step
    return best


def load_view(model, view_dir):
    """Load ``view_dir``'s weights into ``model``, in the JAX package's
    order: its highest-step TF1 bundle, imported into the flax-keyed tree
    (suffix-matched, shapes checked), else its highest ``step_<N>/`` orbax
    checkpoint (``checkpoints.restore_params`` against the model's tree),
    else its ``params.npz``.  Returns the prefix, step directory or file
    loaded, or None where the directory holds none.  A corrupt bundle or
    step directory, a missing tensor, shard or array, or a shape that
    disagrees raises, as ``TPUPredictor.restore`` re-raises all but a
    missing checkpoint."""
    prefix = latest_tf1_prefix(view_dir)
    if prefix is not None:
        template = params_to_flax(model.state_dict())
        tree, report = tf1_import.import_tf1_checkpoint(prefix, template)
        load_flax_params(model, tree)
        print('imported TF1 checkpoint {} ({} tensors)'.format(
            prefix, len(report['matched'])))
        return prefix
    step_dir = checkpoints.latest_checkpoint(view_dir)
    if step_dir is not None:
        tree = checkpoints.restore_params(
            view_dir, template=params_to_flax(model.state_dict()))
        load_flax_params(model, tree)
        print('restored predictor params from {}'.format(step_dir))
        return step_dir
    path = os.path.join(view_dir, PARAMS_FILE)
    if os.path.isfile(path):
        load_flax_params(model, unflatten_flax(read_npz(path)))
        print('restored predictor params from {}'.format(path))
        return path
    return None


def _to_host(t):
    """``t`` as a numpy array.  From the card it is copied through pinned
    host memory: at the host loop's sizes (hundreds of MB a call) a copy
    into pageable memory runs at a fraction of the link's rate."""
    if t.device.type == 'cpu':
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()
