"""Hopper kernels of the Flex-PE hot spots, each beside its plain
PyTorch version: fxp_gemm (fused integer GEMM with the CORDIC AF
epilogue) and paged_attention (decode attention off the paged KV pool).
`dispatch` routes the policy ops to them; `build` compiles `csrc/`."""
