"""Device choice for the port's entry points."""

import torch


def resolve_device(device='cuda', index=None):
    """``torch.device`` for ``device``; a CUDA device without a card raises
    instead of quietly running on the CPU.  ``index`` (a worker's card, as
    ``--gpu_id`` gives it) places a ``'cuda'`` that names no card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None and index is not None:
        device = torch.device('cuda', index)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           'to run the plain PyTorch path on the CPU')
    return device
