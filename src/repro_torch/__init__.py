"""PyTorch/CUDA port of the MOSS reproduction (``repro``).

The same layout and names as ``repro``; plain PyTorch around hand-written
Hopper kernels (``repro_torch.kernels``, sources in ``csrc/``).  This
package imports neither JAX nor anything of ``repro``.  Entry points run
on the card (``device="cuda"``) unless the caller asks for the CPU,
where every kernel takes its plain PyTorch version."""
