"""vits_torch — the PyTorch/CUDA port of vits_tpu for NVIDIA Hopper (H100).

Mirrors ``vits_tpu``'s layout and names (``vits_torch/ops/...``,
``vits_torch/models/...``) so each module's counterpart is easy to find. The
JAX package is the reference; this package imports nothing of it.

Conventions:
  * public functions keep the JAX layout: channels-last ``[B, T, C]`` and
    masks ``[B, T, 1]``; the ``nn.Module``s run NCL (``[B, C, T]``) inside,
    as the torch reference does, and the synthesizer converts at its edges
  * every random site takes its noise explicitly or draws it from a given
    ``torch.Generator``
  * entry points run on ``cuda`` unless the caller passes ``device="cpu"``
  * the one hand-written kernel (MAS, ``csrc/mas.cu``) is built with ``nvcc``
    at first use; CPU tensors take its plain PyTorch version
"""

__version__ = "0.1.0"
