"""Training of the port's models (PyTorch); counterpart of
``visual_foresight_tpu/training/``."""
