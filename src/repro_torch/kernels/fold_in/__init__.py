"""Serving fold-in kernel package: ``csrc/fold_in.cu`` (the CUDA kernel),
``kernel.py`` (its ctypes wrapper), ``ref.py`` (its plain PyTorch version)
and ``ops.py`` (the device dispatch the serving path calls)."""
from repro_torch.kernels.fold_in.ops import (draw_fold_in_randoms,
                                             fold_in_sweeps_drawn)

__all__ = ["draw_fold_in_randoms", "fold_in_sweeps_drawn"]
