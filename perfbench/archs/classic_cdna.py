"""Architecture of ``classic_cdna``: the JAX package's default predictor,
the classic three-scale CDNA/SNA backbone."""

from perfbench.reference.classic import Reference, param_specs  # noqa: F401

PUBLISHED_CONFIG = 'benchmarks/models/classic_cdna/model_config.json'
PUBLISHED_PARAMS = 2004891
