"""The system under test: ``visual_foresight_torch``'s CDNA predictor and
fused CEM planner, built for a cell and driven one replan at a time.

A replan is what ``PixelCostController.perform_CEM`` does on the fused path:
``FusedCEMPlanner.replan`` over the camera models with the context frames,
states, distributions and executed actions as host arrays, the goal
distance grids, the initial distribution and, here, the given draws; it
ends when the best actions and every iteration's scores (and, under
``predictor_propagation``, the best plan's predicted distributions) have
been read to the host.  A mix's ``sample_chunk`` (0, all samples in one
batch, where it has none) is the planner's.
"""

import torch

from visual_foresight_torch.models.cdna import CDNAPredictor
from visual_foresight_torch.ops.cdna_tail import fused_warp_composite
from visual_foresight_torch.planners.cem import FusedCEMPlanner
from visual_foresight_torch.planners.gaussian import (initial_mean,
                                                      initial_sigma,
                                                      make_action_spec)

from perfbench.generator import DTYPES


def build_model(cfg, traffic, weights, device):
    """One camera's predictor with ``weights`` loaded, in inference mode;
    each tensor must arrive in the type the module serves it in."""
    with torch.device('meta'):
        model = CDNAPredictor(
            tuple(cfg['img_dims']), n_context=cfg['context_frames'],
            num_masks=cfg['num_masks'], kernel_size=cfg['kernel_size'],
            sna=cfg['sna'], dna=cfg['dna'],
            num_distribs=traffic['designated_pixels'], sdim=cfg['sdim'],
            adim=cfg['adim'], dtype=DTYPES[cfg['dtype']],
            enc_features=tuple(cfg['enc_features']),
            lstm_kernel=cfg['lstm_kernel'],
            separable_lstm=cfg['separable_lstm'],
            std_factor=cfg['std_factor'],
            renorm_distribs=cfg['renorm_distribs'],
            mask_softmax=cfg['mask_softmax'], latent_dim=cfg['latent_dim'],
            fuse_decode=cfg['fuse_decode'])
    model = model.to_empty(device=device)
    served = model.state_dict()
    wrong = sorted(n for n, t in weights.items()
                   if n in served and served[n].dtype != t.dtype)
    if wrong:
        raise ValueError('weights not in their served type: {}'.format(wrong))
    model.load_state_dict(weights, strict=True)
    return model.eval()


class Program:
    """The models and planner of one cell."""

    def __init__(self, cfg, traffic, weights, device):
        self.traffic = traffic
        self.models = [build_model(cfg, traffic, weights, device)
                       for _ in range(traffic['ncam'])]
        hp = {k: traffic[k] for k in ('initial_std', 'initial_std_lift',
                                      'initial_std_rot', 'initial_std_grasp',
                                      'action_order', 'nactions', 'repeat')}
        spec = make_action_spec(hp, cfg['adim'])
        self.planner = FusedCEMPlanner(
            spec, traffic['num_samples'], iterations=traffic['iterations'],
            k_elite=traffic['k_elite'], finalweight=traffic['finalweight'],
            rejection_rounds=traffic['rejection_rounds'],
            action_bound=traffic['action_bound'], n_vis=traffic['n_vis'],
            sample_chunk=traffic.get('sample_chunk', 0), device=device)
        self.mean = initial_mean(spec, device=device)
        self.sigma = initial_sigma(spec, device=device)

    def replan(self, x):
        """One replan of the inputs ``x`` (``Workload.inputs``); returns the
        host copies the controller reads."""
        res = self.planner.replan(
            self.models, x['images'], x['states'], x['distribs'],
            x['actions'], x['grids'], self.mean, self.sigma,
            noise=x['noise'], latents=x['latents'],
            vis_latents=x['vis_latents'])
        out = {'best_actions': res['best_actions'].cpu().numpy(),
               'scores': res['scores_per_itr'].cpu().numpy()}
        if self.traffic['predictor_propagation']:
            out['best_distribs'] = \
                res['vis']['gen_distribs'][0].cpu().numpy()
        return out


def tail_launches():
    """Launches of the CDNA tail kernel so far in this process."""
    return fused_warp_composite.launches
