"""Device choice for the port's entry points."""

import torch


def resolve_device(device='cuda'):
    """``torch.device`` for ``device``; a CUDA device without a card raises
    instead of quietly running on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           'to run the plain PyTorch path on the CPU')
    return device
