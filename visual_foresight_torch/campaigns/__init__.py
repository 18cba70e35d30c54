"""Campaign configs of the port: twins of ``benchmarks/*/hparams.py`` with
the port's classes and numpy weights.  Run one with
``python -m visual_foresight_torch.sim.run <file> --benchmark``; its reports
land in ``runs/<campaign>/verbose/`` beside these files (or under
``$VMPC_RESULT_DIR``)."""
