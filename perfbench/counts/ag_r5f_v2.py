"""Counts of ``ag_r5f_v2``: the space-to-depth CDNA/SNA predictor with a
latent (the latent widens ``cond_proj``'s input only)."""

from perfbench.counts.s2d_cdna import step_flops, tail_cost  # noqa: F401
