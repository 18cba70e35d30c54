"""Device meshes for running the port over several devices (PyTorch).

Counterpart of ``visual_foresight_tpu/parallel/mesh.py``.  The reference's
only multi-device mechanism was data-parallel inference towers (the batch
sliced per GPU, ``visual_mpc/video_prediction/setup_predictor.py:31-58``);
the JAX package shards the CEM-sample and training-batch axis over a 1-D
``jax.sharding.Mesh``.  Here a mesh is one process's tuple of devices: the
controller splits the leading axis into one piece a device, runs each piece
there, and gathers the results onto the lead device (``devices[0]``).  A
device may appear more than once (``make_mesh(n, device='cpu')``, or
``'cuda:0'``): the pieces then run in turn on it, the counterpart of the
JAX tests' virtual eight-device CPU mesh.  ``batch_sharding`` and
``replicated`` describe ``jax.jit`` shardings and have no counterpart here.
"""

import copy
import dataclasses

import torch

from visual_foresight_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices`` (a tuple of ``torch.device``, the lead
    first) along the axis ``axis_names[0]``."""
    devices: tuple
    axis_names: tuple = ('data',)

    def __post_init__(self):
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        object.__setattr__(self, 'devices',
                           tuple(_indexed(d) for d in self.devices))

    @property
    def size(self):
        return len(self.devices)

    @property
    def lead(self):
        return self.devices[0]


def _indexed(device):
    """``device`` as a ``torch.device``; a CUDA device without an index
    takes the current one's, as the tensors placed there report it."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def make_mesh(n_devices=None, axis_name='data', device='cuda'):
    """1-D mesh over the first ``n_devices`` devices of ``device``'s type
    (all of them where None), as JAX takes the first of ``jax.devices()``.
    A device that names one device (``'cpu'``, ``'cuda:0'``) gives
    ``n_devices`` entries of it (one where None).  ``'cuda'`` without a card
    raises (``device.resolve_device``), as does asking for more cards than
    there are."""
    device = resolve_device(device)
    if device.type == 'cuda' and device.index is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if not 0 < n <= count:
            raise ValueError('asked for {} CUDA devices, {} present; name '
                             'one (cuda:0) to repeat it'.format(n, count))
        devices = [torch.device('cuda', i) for i in range(n)]
    else:
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError('a mesh needs at least one device')
        devices = [device] * n
    return Mesh(tuple(devices), (axis_name,))


def shard_bounds(mesh, n):
    """(lo, hi) row bounds of the ``mesh.size`` pieces of an axis of length
    ``n``, in order; the first ``n % size`` pieces hold one row more (some
    are empty where ``n < size``)."""
    per, extra = divmod(n, mesh.size)
    bounds, lo = [], 0
    for i in range(mesh.size):
        hi = lo + per + (i < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, tree):
    """Split the leading axis of every tensor in ``tree`` (nested dicts,
    lists, tuples; other leaves are kept) into ``mesh.size`` equal pieces,
    piece ``i`` on ``mesh.devices[i]``.  Returns a list of trees, one a
    device.  Raises where an axis does not divide."""
    pieces = []
    for i, dev in enumerate(mesh.devices):
        def piece(x, i=i, dev=dev):
            if not isinstance(x, torch.Tensor):
                return x
            if x.shape[0] % mesh.size:
                raise ValueError('a leading axis of {} does not divide over '
                                 '{} devices'.format(x.shape[0], mesh.size))
            per = x.shape[0] // mesh.size
            return x[i * per:(i + 1) * per].to(dev)
        pieces.append(_map(piece, tree))
    return pieces


def replicate(mesh, tree_or_module):
    """One copy of a module or tensor tree a device of the mesh; a device
    that repeats shares its copy, and the lead's copy is the original where
    it already lies there (a module is moved with ``.to``, so it is best
    built on the lead).  Returns a list, one entry a mesh device."""
    copies = {}

    def copy_to(dev):
        if dev not in copies:
            x = tree_or_module
            if isinstance(x, torch.nn.Module):
                copies[dev] = x if _module_device(x) == dev else \
                    copy.deepcopy(x).to(dev)
            else:
                copies[dev] = _map(lambda t: t.to(dev) if isinstance(
                    t, torch.Tensor) else t, x)
        return copies[dev]
    return [copy_to(dev) for dev in mesh.devices]


def _module_device(module):
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return None


def gather(mesh, pieces, dim=0):
    """Concatenate ``pieces`` (tensors, one a device, some may be empty)
    along ``dim`` onto the lead device."""
    return torch.cat([p.to(mesh.lead) for p in pieces], dim=dim)
