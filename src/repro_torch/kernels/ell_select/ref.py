"""Plain PyTorch version of the ELL kernel: the stable sort of
``core.updates`` (``ell_topk_plain``, ``theta_to_ell_plain``), which the
CPU path runs and the CUDA kernel is held to, bit for bit, on the card."""
from repro_torch.core.updates import ell_topk_plain as ell_topk_ref
from repro_torch.core.updates import theta_to_ell_plain as theta_to_ell_ref

__all__ = ["ell_topk_ref", "theta_to_ell_ref"]
