"""PyTorch port of the approximate-inference stack, for one NVIDIA H100.

Mirrors ``src/repro`` module for module, so each counterpart is found
under the same name.  It imports ``torch`` and numpy and nothing of the
JAX package: what it needs from there is copied.  The LUT matmul and the
flash attention kernels are CUDA C++ written for ``sm_90a``
(:mod:`repro_torch.kernels`); everything around them is plain PyTorch.

Entry points that create tensors take ``device=`` (default ``"cuda"``)
and raise when no card is present unless the caller asks for ``"cpu"``,
where every kernel runs its plain PyTorch version.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
