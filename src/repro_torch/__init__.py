"""repro_torch — the CuLDA_CGS serving path in PyTorch for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: the same module paths
and names (``repro_torch/serve/infer.py::fold_in_buffer`` is the counterpart
of ``repro/serve/infer.py::fold_in_buffer``), written as plain functions on
tensors with an explicit ``device`` and explicit ``torch.Generator``s.  The
fold-in sweeps run a hand-written CUDA kernel on the card
(``kernels/fold_in``) and its plain PyTorch version on the CPU.

Imports ``torch``, numpy and the standard library only — never ``jax`` and
nothing of ``repro``.
"""
