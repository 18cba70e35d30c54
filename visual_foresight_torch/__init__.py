"""PyTorch/CUDA port of the visual-foresight serving path for NVIDIA Hopper.

The package mirrors ``visual_foresight_tpu``'s layout (``ops/``, ``models/``,
``planners/``, ``prediction/``) and keeps its NHWC layout at public function
boundaries.  The CDNA warp-and-composite tail runs as a hand-written CUDA
kernel (``csrc/cdna_tail.cu``); everything else is stock PyTorch.

Entry points (``TorchPredictor``, ``FusedCEMPlanner``) run on the card unless
the caller passes ``device='cpu'``.
"""
