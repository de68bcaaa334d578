"""Training-sweep kernel package: ``csrc/lda_sample.cu`` (the CUDA kernel
K1), ``kernel.py`` (its ctypes wrapper), ``ref.py`` (its plain PyTorch
version) and ``ops.py`` (the device dispatch the trainer calls)."""
from repro_torch.kernels.lda_sample.ops import lda_sample

__all__ = ["lda_sample"]
