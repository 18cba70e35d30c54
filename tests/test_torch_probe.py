"""Port parity: the toolchain probe ``ops/probe.py`` against the Pallas
``add_one`` of ``scripts/pallas_device_probe.py`` (stage 1: ``x + 1`` on an
(8, 128) f32 array), run in interpret mode on the CPU.  The kernel itself
is held against its plain version on the card (``tests/test_torch_cuda.py``).

Tolerance: exact.  Adding one to a float is one correctly rounded IEEE
operation on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from visual_foresight_torch.ops.probe import (PROBE_SHAPE, add_one,
                                              add_one_reference,
                                              toolchain_probe)


def _pallas_add_one(x):
    """The probe's Pallas kernel, as ``scripts/pallas_device_probe.py``
    writes it, in interpret mode."""
    def add_one_kernel(x_ref, o_ref):
        o_ref[:] = x_ref[:] + 1.0
    return pl.pallas_call(
        add_one_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(x)


@pytest.mark.parametrize('fill', ['zeros', 'random'])
def test_add_one_matches_pallas_probe(fill):
    rng = np.random.RandomState(0)
    x = np.zeros(PROBE_SHAPE, np.float32) if fill == 'zeros' else \
        (rng.randn(*PROBE_SHAPE) * 1e3).astype(np.float32)
    want = np.asarray(_pallas_add_one(jnp.asarray(x)))
    np.testing.assert_array_equal(add_one_reference(torch.tensor(x)).numpy(),
                                  want)
    before = add_one.launches
    np.testing.assert_array_equal(add_one(torch.tensor(x)).numpy(), want)
    assert add_one.launches == before    # the CPU takes the plain version


def test_toolchain_probe_on_cpu_takes_plain_version():
    y = toolchain_probe(device='cpu')
    assert tuple(y.shape) == PROBE_SHAPE and bool((y == 1).all())
