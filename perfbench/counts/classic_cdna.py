"""Counts of ``classic_cdna``: the classic three-scale CDNA/SNA
predictor."""

from perfbench.counts.classic import step_flops, tail_cost  # noqa: F401
