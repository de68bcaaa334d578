"""The ELL of theta: ``csrc/ell_select.cu`` (a CUDA kernel of the port with
no TPU counterpart: the JAX package leaves this step to ``lax.top_k``),
``kernel.py`` (its ctypes wrapper and custom op) and ``ref.py`` (its plain
PyTorch version, a stable sort).  ``core.updates.ell_topk`` and
``theta_to_ell`` send CUDA tensors to the kernel and CPU tensors to the
plain version."""
