"""Architecture of ``xz_flagship``: the space-to-depth CDNA/SNA predictor."""

from perfbench.reference.model import Reference, param_specs  # noqa: F401

PUBLISHED_CONFIG = 'benchmarks/models/xz_flagship/model_config.json'
PUBLISHED_PARAMS = 4352719
