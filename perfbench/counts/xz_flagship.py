"""Counts of ``xz_flagship``: the space-to-depth CDNA/SNA predictor."""

from perfbench.counts.s2d_cdna import step_flops, tail_cost  # noqa: F401
