"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The JAX package (``src/repro``) is the reference; this package mirrors its
module paths and parameter tree. It imports nothing of JAX or of ``repro``:
what it needs from there is copied. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
