"""The replan sharded over a mesh at the serving geometry.

Counterpart of ``visual_foresight_tpu/parallel/flagship_check.py``.  The
small-shape mesh tests show that the sharded replan is the unsharded one;
serving runs 48x64 frames, 200 samples and the trained flagship in bf16,
where each device's share has other shapes.  This module builds exactly
that configuration so that

* a test holds sharded against unsharded at the flagship's shapes
  (``tests/test_torch_mesh.py``, marked ``slow`` as the JAX one is),
* ``tools/dryrun_multichip.py`` runs it over an n-device mesh, and
* ``chip_smoke.py`` runs it on the card over meshes of 1, 2 and 4 entries.

The reference's only counterpart was slicing the CEM batch across GPU towers
(``visual_mpc/video_prediction/setup_predictor.py:31-58``).
"""

import os

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device

H, W, NCAM, P = 48, 64, 1, 1
N_CTX = 2
NACT, REPEAT = 5, 3
K_ELITE, N_VIS = 10, 4

VENDORED_FLAGSHIP = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', 'weights',
    'xz_flagship'))


def load_flagship_predictor(model_dir=None, num_samples=200, device='cuda',
                            dtype='bfloat16'):
    """Restore the flagship's numpy export (the architecture comes from its
    ``model_config.json``) as ``TorchPredictor`` on ``device``."""
    from visual_foresight_torch.prediction.predictor import TorchPredictor
    predictor = TorchPredictor(model_dir or VENDORED_FLAGSHIP, {
        'designated_pixel_count': P, 'run_batch_size': num_samples,
        'sequence_length': NACT * REPEAT + N_CTX, 'context_frames': N_CTX,
        'ncam': NCAM, 'img_dims': (H, W), 'adim': 3, 'sdim': 3,
        'dtype': dtype, 'std_factor': 4,
        'enc_features': (128, 256, 256), 'separable_lstm': True,
        'lstm_kernel': 3}, device=device)
    predictor.restore()
    return predictor


def flagship_inputs(seed=0, device='cpu'):
    """The replan's context, made by ``np.random.RandomState(seed)`` as the
    JAX module makes it: (images, states, distribs, context actions, goal
    distance grids)."""
    from visual_foresight_torch.planners import costs as cost_lib
    rng = np.random.RandomState(seed)
    images = rng.rand(NCAM, N_CTX, H, W, 3).astype(np.float32)
    states = (rng.randn(N_CTX, 3) * 0.05).astype(np.float32)
    distribs = np.zeros((NCAM, N_CTX, H, W, P), np.float32)
    distribs[:, :, 24, 32, 0] = 1.0
    ctx_actions = np.zeros((N_CTX - 1, 3), np.float32)
    grids = cost_lib.distance_grid([[[10.0, 50.0]]], H, W, device=device)
    return images, states, distribs, ctx_actions, grids


def flagship_replan(mesh=None, model_dir=None, num_samples=200,
                    iterations=2, seed=0, predictor=None, device='cuda',
                    dtype='bfloat16'):
    """One whole CEM replan at the serving geometry; returns (result,
    predictor).

    ``mesh=None`` runs unsharded on ``device``; otherwise the samples are
    split over the mesh and the replan runs on its lead device.  The plans
    are drawn from a generator seeded with ``seed`` on that device, so a
    sharded and an unsharded replan draw the same.  Pass ``predictor`` (on
    that device) to reuse one restore across runs.
    """
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.planners.gaussian import (initial_mean,
                                                          initial_sigma,
                                                          make_action_spec)
    device = mesh.lead if mesh is not None else resolve_device(device)
    if predictor is None:
        predictor = load_flagship_predictor(model_dir, num_samples, device,
                                            dtype)
    hp = {'initial_std': 0.05, 'initial_std_lift': 0.15,
          'initial_std_rot': np.pi / 18, 'initial_std_grasp': 2,
          'action_order': ['x', 'z', 'grasp'], 'nactions': NACT,
          'repeat': REPEAT}
    spec = make_action_spec(hp, 3)
    planner = FusedCEMPlanner(spec, num_samples, iterations=iterations,
                              k_elite=K_ELITE, finalweight=10.0,
                              rejection_rounds=0, action_bound=True,
                              n_vis=N_VIS, mesh=mesh, device=device)
    images, states, distribs, ctx_actions, grids = flagship_inputs(
        seed, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    result = planner.replan(predictor.models, images, states, distribs,
                            ctx_actions, grids,
                            initial_mean(spec, device=device),
                            initial_sigma(spec, device=device),
                            generator=generator)
    return result, predictor
