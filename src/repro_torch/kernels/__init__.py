"""Hand-written Hopper kernels, each beside its plain PyTorch version
(``mx_gemm``, ``mx_fused``, ``mx_bwd``, ``mx_quant``, ``group_gemm``,
``moe_gmm``, ``decode_attn``), the dispatch layer above them and the ablation entry
points (``ops``).  Importing this package builds nothing: the CUDA
library is compiled at the first launch on a card."""
