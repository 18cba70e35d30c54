"""How a call reaches a hand-written kernel: the one decision between the
kernel and the plain version (:func:`route`) and the one way a C entry
point of ``csrc/`` is declared and launched (:class:`Entry`).

Every entry of ``ops/`` and every route of ``models/layers.py`` asks
:func:`route`; every kernel launch goes through :meth:`Entry.launch`, which
enters the tensors' device, passes PyTorch's current stream and raises on a
failed launch.  Nothing is built or loaded at import: a library is built
(``_build.load``) at its entry's first launch.
"""

import ctypes

import torch

from visual_foresight_torch.ops import _build

# the C entry points' dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(*tensors):
    """How a call on ``tensors`` (None entries skipped; the first one's
    device decides) runs: ``'plain'`` on the CPU (the plain version or the
    stock ops); on a CUDA device ``'graph'`` where autograd would record a
    graph of them (grad mode on and one of them needs a gradient), else
    ``'kernel'``.  Any other device raises."""
    first = tensors[0]
    if first.is_cuda:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in tensors):
            return 'graph'
        return 'kernel'
    if first.device.type == 'cpu':
        return 'plain'
    raise ValueError('no hand-written kernel for device {}'.format(
        first.device))


def no_backward(entry):
    """Raise for an entry that, on the card, has no backward kernel."""
    raise RuntimeError(
        '{} has no backward kernel: on the card it serves inference only; '
        'call it under torch.no_grad() or with inputs that need no gradient'
        .format(entry))


class Entry:
    """The C entry point ``symbol`` of ``csrc/<source>``: it takes
    arguments of the ctypes types ``argtypes``, then the stream, and returns
    the launch's ``cudaError_t``."""

    def __init__(self, source, symbol, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self._fn = None

    def launch(self, device, *args):
        """Launch on ``device``'s current stream with ``args`` (the library
        built and loaded at the first launch); raise ``RuntimeError`` if the
        entry returns a CUDA error."""
        fn = self._fn
        if fn is None:
            fn = getattr(_build.load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError('{} launch failed: cudaError {}'.format(
                self.symbol, err))
