"""Architecture of ``ag_r5f_v2``: the space-to-depth CDNA/SNA predictor
with a latent."""

from perfbench.reference.model import Reference, param_specs  # noqa: F401

PUBLISHED_CONFIG = 'benchmarks/models/ag_r5f_v2/model_config.json'
PUBLISHED_PARAMS = 4364012
