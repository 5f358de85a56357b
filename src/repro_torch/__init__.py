"""PyTorch/CUDA port of the EcoSched campaign scheduling engine.

Mirrors ``src/repro/`` module for module (``core/``, ``kernels/``,
``data/``, ``utils/``) and is held against it by the ``tests/test_torch_*``
parity suite.  The port imports ``torch``, numpy and the standard library
only.  Its entry points run on the CUDA device unless the caller asks for
the CPU (``device="cpu"``); they never fall back to the CPU by themselves.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
