"""The port's own copies of the JAX package's campaign runner
(``visual_foresight_tpu/sim``: ``run.py``, ``simulator.py``,
``benchmarks.py`` and ``util/``), driving the port's agents, envs and
controllers."""
