"""Training count-update kernel package: ``csrc/phi_update.cu`` (the CUDA
kernels K2 ``phi_delta_tiles`` and K4 ``phi_update_tiles``), ``kernel.py``
(their ctypes wrappers), ``ref.py`` (their plain PyTorch versions) and
``ops.py`` (the device dispatch the trainer calls)."""
from repro_torch.kernels.phi_update.ops import phi_delta, phi_update

__all__ = ["phi_delta", "phi_update"]
