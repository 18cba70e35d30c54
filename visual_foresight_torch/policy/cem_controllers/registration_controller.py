"""Goal-registration CEM controller (PyTorch port).

Counterpart of ``visual_foresight_tpu/policy/cem_controllers/
registration_controller.py``: before each replan the GDN flow net warps the
current frame of every camera onto the start and the goal image.  The warp
points at the designated (start) and goal pixels relocate the designated
pixels, and the warp errors around them become per-(camera, task,
registration) tradeoffs, normalised over cameras and registrations, that
weight the pixel-distance cost: each (camera, pixel) distance grid is scaled
by its tradeoff on the fused path (``_cost_grids``), and the host loop
blends the per-pixel scores by them (``_eval_pixel_cost``).  Each task
carries one designated pixel per registration, so the predictor runs
``ntask * len(register_gtruth)`` distributions a camera.

The GDN is ``GoalDistanceNet()`` at its default widths, restored from
``gdn_path`` by ``models/convert.py::restore_network``: its latest orbax
``step_<N>/``, as the JAX controller reads it, else its ``params.npz``
(seeded weights, with a warning, where it has neither; ``gdn_restored``
tells which).  Paths, device and draws are
``PixelCostController``'s.
"""

import numpy as np
import torch

from visual_foresight_torch.models.convert import restore_network
from visual_foresight_torch.models.gdn import GoalDistanceNet
from visual_foresight_torch.planners import costs as cost_lib
from .pixel_cost_controller import PixelCostController


class RegisterGtruthController(PixelCostController):
    def __init__(self, ag_params, policyparams, gpu_id=0, ngpu=1):
        pp = dict(policyparams)
        num_reg = len(pp.get('register_gtruth', ['start', 'goal']))
        self._ntask = ag_params.get('ntask', 1)
        pp.setdefault('designated_pixel_count', self._ntask * num_reg)
        super().__init__(ag_params, pp, gpu_id, ngpu)

        self._num_reg = num_reg
        self.reg_tradeoff = np.ones([self._n_cam, self._n_desig]) \
            / self._n_cam / self._n_desig

        self.gdn = GoalDistanceNet()
        self.gdn_restored = restore_network(self.gdn, self._hp.gdn_path)
        self.gdn.to(self.device).eval()

        self._start_image = None
        self._goal_image = None
        self._desig_pix_t0 = None
        self._goal_pix_sel = None

    def _default_hparams(self):
        parent_params = super()._default_hparams()
        parent_params.add_hparam('register_gtruth', ['start', 'goal'])
        parent_params.add_hparam('register_region', False)
        parent_params.add_hparam('gdn_path', '')
        return parent_params

    # -- registration ----------------------------------------------------------
    @torch.no_grad()
    def _register(self, current_frames):
        """Warp each camera's current frame onto the start and goal images;
        returns (desig (ncam, ndesig, 2), tradeoff (ncam, ndesig))."""
        width = 5 if self._img_height >= 96 else 2
        desig = np.zeros((self._n_cam, self._ntask, self._num_reg, 2))
        warperrs = np.zeros((self._n_cam, self._ntask, self._num_reg))

        refs = []
        if 'start' in self._hp.register_gtruth:
            refs.append(('start', self._start_image))
        if 'goal' in self._hp.register_gtruth:
            refs.append(('goal', self._goal_image))

        as_dev = lambda x: torch.as_tensor(
            np.ascontiguousarray(x, np.float32), device=self.device)[None]
        for icam in range(self._n_cam):
            cur = as_dev(current_frames[icam])
            for r, (name, ref_imgs) in enumerate(refs):
                ref_np = np.asarray(ref_imgs[icam], np.float32)
                warped, _, warp_pts = self.gdn(cur, as_dev(ref_np))
                warped = warped[0].cpu().numpy()
                warp_pts = warp_pts[0].cpu().numpy()
                for p in range(self._ntask):
                    pix = self._desig_pix_t0[icam, p] if name == 'start' \
                        else self._goal_pix_sel[icam, p]
                    r_rng = np.clip([pix[0] - width, pix[0] + width + 1], 0,
                                    self._img_height - 1).astype(int)
                    c_rng = np.clip([pix[1] - width, pix[1] + width + 1], 0,
                                    self._img_width - 1).astype(int)
                    rows, cols = slice(*r_rng), slice(*c_rng)
                    warperrs[icam, p, r] = np.mean(np.square(
                        ref_np[rows, cols] - warped[rows, cols])) + 1e-6
                    if self._hp.register_region:
                        field = warp_pts[rows, cols]
                        desig[icam, p, r] = [np.median(field[:, :, 0]),
                                             np.median(field[:, :, 1])]
                    else:
                        desig[icam, p, r] = warp_pts[int(pix[0]), int(pix[1])]

        tradeoff = 1.0 / warperrs
        normalizer = np.sum(np.sum(tradeoff, 0, keepdims=True), 2,
                            keepdims=True)
        tradeoff = (tradeoff / normalizer).reshape(self._n_cam, self._n_desig)
        return desig.reshape(self._n_cam, self._n_desig, 2), tradeoff

    def perform_CEM(self, state):
        # refresh the designated pixels and the tradeoffs from the
        # registration
        current = self._images[-1].astype(np.float32) / 255.0
        desig, tradeoff = self._register(current)
        self._desig_pix = np.clip(
            np.round(desig), 0,
            [[[self._img_height - 1, self._img_width - 1]]]).astype(np.int64)
        self.reg_tradeoff = tradeoff
        self.plan_stat['tradeoff'] = tradeoff
        super().perform_CEM(state)

    def _cost_grids(self):
        """Tradeoff-weighted distance grids for the fused planner: the
        expected pixel distance is linear in the grid, so scaling each
        (camera, pixel) grid by its tradeoff gives the host path's weighted
        sum (``_eval_pixel_cost``) up to the constant factor ncam * ndesig,
        to which the ranking is blind."""
        grids = super()._cost_grids()
        w = torch.as_tensor(self.reg_tradeoff * self._n_cam * self._n_desig,
                            dtype=grids.dtype, device=grids.device)
        return grids * w[:, :, None, None]

    def _eval_pixel_cost(self, cem_itr, gen_distrib, gen_images):
        """The host loop's cost: per-(camera, pixel) scores blended by the
        tradeoffs, in numpy as the JAX package computes it."""
        grids = cost_lib.distance_grid(
            self._goal_pix.reshape(self._n_cam, self._n_desig, 2),
            self._img_height, self._img_width).numpy()
        d = gen_distrib.astype(np.float32)
        tot = d.sum(axis=(3, 4), keepdims=True)
        d = d / np.maximum(tot, 1e-6)
        per_t = np.einsum('btchwp,cphw->btcp', d, grids)
        w = np.ones(per_t.shape[1], np.float32)
        w[-1] = self._hp.finalweight
        per_task = np.sum(per_t * w[None, :, None, None], axis=1) / w.sum()
        weighted = per_task * self.reg_tradeoff[None]
        return weighted.reshape(weighted.shape[0], -1).sum(axis=1)

    def act(self, t=None, i_tr=None, desig_pix=None, goal_pix=None,
            images=None, goal_image=None, state=None, verbose_worker=None):
        # multi-object scenes pass pixels for every object; plan for the
        # first ntask of them (as PixelCostController.act does)
        self._goal_pix_sel = np.array(goal_pix).reshape(
            (self._n_cam, -1, 2))[:, :self._ntask]
        goal_pix_full = np.tile(self._goal_pix_sel[:, :, None, :],
                                [1, 1, self._num_reg, 1]).reshape(
            self._n_cam, self._n_desig, 2)
        desig_full = np.tile(
            np.array(desig_pix).reshape(
                (self._n_cam, -1, 2))[:, :self._ntask, None],
            [1, 1, self._num_reg, 1]).reshape(self._n_cam, self._n_desig, 2)

        if t is not None and (self._desig_pix_t0 is None or t <= 1):
            self._desig_pix_t0 = np.array(desig_pix).reshape(
                (self._n_cam, -1, 2))[:, :self._ntask]
            self._start_image = images[0].astype(np.float32) / 255.0
        if goal_image is not None:
            gi = np.asarray(goal_image, np.float32)
            self._goal_image = gi[-1] if gi.ndim == 5 else gi

        return super().act(t, i_tr, desig_full, goal_pix_full, images, state,
                           verbose_worker)
