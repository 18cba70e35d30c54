"""The run's guard against the reference package: no module whose
top-level name is one of ``FORBIDDEN`` may be loaded in the process that
prints a result."""

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'visual_foresight_tpu')


def found():
    """Top-level names of loaded modules that the run may not hold."""
    tops = {name.split('.')[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))
