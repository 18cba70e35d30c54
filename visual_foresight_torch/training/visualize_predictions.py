"""Qualitative predictor evaluation: ground-truth vs predicted rollout strips.

The port's counterpart of
``visual_foresight_tpu/training/visualize_predictions.py``.  Loads a trained
predictor, rolls the first ``--n`` trajectories of a record set from their
context frames and actions, prints the per-step PSNR of the rollout (the
number that matters for planning, unlike teacher-forced training PSNR) and
writes one PNG strip a trajectory (top: ground truth, bottom: prediction).

The weights come from ``<model_dir>/view0/`` (``prediction.predictor.
load_view``): its latest TF1 bundle, else its latest orbax ``step_<N>/``,
the checkpoint the JAX tool reads, else its ``params.npz``.  The model is built from the trainer's flags
(``train_predictor.build_argparser``) and runs on the card unless
``--device cpu`` is given.  ``cv2`` is imported when the strips are
written.

CLI::

    python -m visual_foresight_torch.training.visualize_predictions \
        --data_dir <records> --model_dir <ckpts> [--n 4 --out_dir preds]
"""

import json
import os

import numpy as np
import torch

from visual_foresight_torch.data.dataset_reader import BaseVideoDataset
from visual_foresight_torch.device import resolve_device
from visual_foresight_torch.prediction.predictor import load_view
from visual_foresight_torch.training.train_predictor import (build_argparser,
                                                             build_model)


def main(cmd_args=None):
    parser = build_argparser()
    parser.add_argument('--n', type=int, default=4)
    parser.add_argument('--out_dir', type=str, default='pred_vis')
    parser.add_argument('--mode', type=str, default='val')
    args = parser.parse_args(cmd_args)
    device = resolve_device(args.device)

    model = build_model(args)
    view_dir = os.path.join(args.model_dir, 'view0')
    if load_view(model, view_dir) is None:
        raise FileNotFoundError('no TF1 bundle, checkpoint or params.npz in '
                                '{}'.format(view_dir))
    model.to(device).eval()

    ds = BaseVideoDataset(args.data_dir, args.n,
                          hparams_dict={'shuffle': False})
    batch = next(ds.numpy_iterator(keys=('images', 'actions', 'state'),
                                   mode=args.mode))
    ds.close()
    T = args.sequence_length
    images = batch['images'][:, :T, 0].astype(np.float32) / 255.0
    actions = batch['actions'][:, :T - 1].astype(np.float32)
    states = batch['state'][:, :T].astype(np.float32)

    dev = lambda x: torch.as_tensor(x, device=device)
    with torch.no_grad():
        out = model(dev(images), dev(actions), dev(states))
    pred = out['gen_images'].float().cpu().numpy()  # predicts frames 1..T-1
    gt = images[:, 1:]

    mse_t = np.mean(np.square(pred - gt), axis=(0, 2, 3, 4))
    psnr_t = -10 * np.log10(np.maximum(mse_t, 1e-10))
    n_ctx = args.context_frames
    report = {
        'psnr_per_step': [round(float(p), 2) for p in psnr_t],
        'psnr_context': round(float(np.mean(psnr_t[:n_ctx - 1])), 2)
        if n_ctx > 1 else None,
        'psnr_autoregressive': round(float(np.mean(psnr_t[n_ctx - 1:])), 2),
        'psnr_final_step': round(float(psnr_t[-1]), 2),
    }
    print(json.dumps(report))

    os.makedirs(args.out_dir, exist_ok=True)
    import cv2
    for b in range(pred.shape[0]):
        strip_gt = np.concatenate(list(gt[b]), axis=1)
        strip_pr = np.concatenate(list(pred[b]), axis=1)
        strip = np.concatenate([strip_gt, strip_pr], axis=0)
        cv2.imwrite(os.path.join(args.out_dir, 'traj{}.png'.format(b)),
                    (np.clip(strip, 0, 1) * 255).astype(np.uint8)[:, :, ::-1])
    print('wrote {} strips (top=ground truth, bottom=prediction) to {}'.format(
        pred.shape[0], args.out_dir))
    return report


if __name__ == '__main__':
    main()
