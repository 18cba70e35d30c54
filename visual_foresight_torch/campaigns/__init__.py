"""Campaign configs of the port: twins of the configs under
``benchmarks/``, ``experiments/`` and ``data_collection/`` with the port's
classes and numpy weights (``stand_ins.py`` where the repo holds none).
Run a benchmark or sim twin with ``python -m visual_foresight_torch.sim.run
<file> [--benchmark]``, a robot twin with ``python -m
visual_foresight_torch.sim.run_robot <file> <robot> [--benchmark]``; the
reports land in ``runs/<campaign>/`` beside these files (or under
``$VMPC_RESULT_DIR``)."""
