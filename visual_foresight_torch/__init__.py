"""PyTorch/CUDA port of the visual-foresight serving path for NVIDIA Hopper.

The package mirrors ``visual_foresight_tpu``'s layout (``ops/``, ``models/``,
``planners/``, ``prediction/``, ``policy/``, ``utils/``) and keeps its NHWC
layout at public function boundaries.  The CDNA warp-and-composite tail
runs as a hand-written CUDA kernel (``csrc/cdna_tail.cu``), and the
toolchain probe's ``add_one`` as another (``csrc/probe_add_one.cu``);
everything else is stock PyTorch.  ``weights/`` holds numpy exports of the
trained checkpoints.

Entry points (``PixelCostController``, ``GoalImController``,
``TorchPredictor``, ``FusedCEMPlanner``) run on the card unless the caller
passes ``device='cpu'``.
"""
