"""Hand-written Hopper kernels of the serving path, each beside its
plain PyTorch version (``mx_gemm``, ``mx_fused``, ``decode_attn``), and
the dispatch layer above them.  Importing this package builds nothing:
the CUDA library is compiled at the first launch on a card."""
