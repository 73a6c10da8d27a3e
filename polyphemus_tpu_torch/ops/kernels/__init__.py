"""Hand-written CUDA kernels of the generation path, each beside its plain
PyTorch version: `gcl` (eval GCL stack) and `chord_tail` (chord decode ->
unembed -> argmax)."""
