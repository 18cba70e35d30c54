"""The multi-device dry run on the port: the twin of
``__graft_entry__.py::_dryrun_multichip_impl``.

Three programs over a mesh of ``--n_devices`` entries
(``parallel/mesh.py``), each printing one line:

1. one data-parallel train step of a small ``CDNAPredictor`` (4 masks, no
   distributions, widths 8, 16, 32) at batch 2n, 6 frames of 16x24;
2. a small sharded replan (2n samples, 2 iterations) of the same model
   with one distribution;
3. the flagship's sharded replan at the serving geometry
   (``parallel/flagship_check.py``: 48x64, 200 samples, bf16, the restored
   flagship), one iteration; ``--no_flagship`` leaves it out.

``--device cuda`` (the default) takes the first n cards, or repeats the
first where there are fewer; ``--device cpu`` runs the plain path on the
CPU over n entries of it.

Usage::

    python -m visual_foresight_torch.tools.dryrun_multichip
        [--n_devices N] [--device cpu] [--no_flagship]
"""

import argparse

import numpy as np
import torch

from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.parallel.mesh import make_mesh


def dryrun_mesh(n_devices, device='cuda'):
    """The mesh of ``n_devices`` entries: the first cards of ``'cuda'``
    where there are that many, else the first card repeated, as the JAX
    dry run repeats the host in a virtual mesh; n entries of a device that
    is named (``'cpu'``, ``'cuda:1'``)."""
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None and \
            torch.cuda.device_count() < n_devices:
        device = torch.device('cuda', 0)
    return make_mesh(n_devices, device=device)


def train_step(mesh):
    """One sharded train step; returns its loss."""
    from visual_foresight_torch.training.train_predictor import (
        adam, init_params, make_train_step, _named_params)
    n = mesh.size
    B, T, H, W = 2 * n, 6, 16, 24
    model = CDNAPredictor((H, W), n_context=2, num_masks=4, num_distribs=0,
                          sdim=3, adim=3, enc_features=(8, 16, 32))
    init_params(model, seed=0)
    model.to(mesh.lead)
    step = make_train_step(model, adam(_named_params(model), 1e-3), 2,
                           mesh=mesh)
    rng = np.random.RandomState(0)
    batch = {
        'images': rng.rand(B, T, H, W, 3).astype(np.float32),
        'actions': (rng.randn(B, T - 1, 3) * 0.1).astype(np.float32),
        'states': (rng.randn(B, T, 3) * 0.1).astype(np.float32),
    }
    batch = {k: torch.as_tensor(v, device=mesh.lead)
             for k, v in batch.items()}
    gen = torch.Generator(device=mesh.lead).manual_seed(1)
    return float(step(batch, 0, gen)['loss'])


def small_replan(mesh):
    """A sharded replan of 2n samples, 2 iterations; returns the result."""
    from visual_foresight_torch.planners import costs as cost_lib
    from visual_foresight_torch.planners.cem import FusedCEMPlanner
    from visual_foresight_torch.planners.gaussian import (initial_mean,
                                                          initial_sigma,
                                                          make_action_spec)
    from visual_foresight_torch.training.train_predictor import init_params
    n, dev = mesh.size, mesh.lead
    H, W = 16, 24
    model = CDNAPredictor((H, W), n_context=2, num_masks=4, num_distribs=1,
                          sdim=3, adim=3, enc_features=(8, 16, 32))
    init_params(model, seed=0)
    model.to(dev).eval()
    spec = make_action_spec({'initial_std': 0.05, 'initial_std_lift': 0.15,
                             'initial_std_rot': np.pi / 18,
                             'initial_std_grasp': 2,
                             'action_order': ['x', 'z', 'grasp'],
                             'nactions': 3, 'repeat': 2}, 3)
    planner = FusedCEMPlanner(spec, num_samples=2 * n, iterations=2,
                              k_elite=n, n_vis=2, mesh=mesh)
    distribs = np.zeros((1, 2, H, W, 1), np.float32)
    distribs[:, :, H // 2, W // 2, 0] = 1.0
    grids = cost_lib.distance_grid([[[4.0, 12.0]]], H, W, device=dev)
    return planner.replan(
        [model], np.zeros((1, 2, H, W, 3), np.float32),
        np.zeros((2, 3), np.float32), distribs, np.zeros((1, 3), np.float32),
        grids, initial_mean(spec, device=dev),
        initial_sigma(spec, device=dev),
        generator=torch.Generator(device=dev).manual_seed(3))


def flagship(mesh):
    """The flagship's sharded replan, one iteration; returns the result."""
    from visual_foresight_torch.parallel.flagship_check import (
        flagship_replan)
    n = mesh.size
    M = 200 if 200 % n == 0 else n * max(1, 200 // n)
    result, predictor = flagship_replan(mesh=mesh, num_samples=M,
                                        iterations=1)
    if not predictor.restored:
        raise RuntimeError('the flagship\'s weights did not restore')
    return result


def run(n_devices, device='cuda', with_flagship=True):
    mesh = dryrun_mesh(n_devices, device)
    n = mesh.size
    print('dryrun_multichip({}) mesh devices: {}'.format(
        n, ', '.join(str(d) for d in mesh.devices)))
    print('dryrun_multichip({}) train step ok: loss={:.5f}'.format(
        n, train_step(mesh)))
    result = small_replan(mesh)
    print('dryrun_multichip({}) sharded replan ok: best={:.5f}'.format(
        n, float(result['best_scores'][0])))
    if with_flagship:
        result = flagship(mesh)
        print('dryrun_multichip({}) FLAGSHIP-shape sharded replan ok '
              '(48x64, M=200, restored flagship): best={:.5f}'.format(
                  n, float(result['best_scores'][0])))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--n_devices', type=int, default=8)
    p.add_argument('--device', default='cuda')
    p.add_argument('--no_flagship', action='store_true')
    args = p.parse_args(argv)
    run(args.n_devices, args.device, not args.no_flagship)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
