"""Hand-written CUDA kernels, each beside its plain PyTorch version: `gcl`
(the eval GCL stack and the training forward), `gcl_bwd` (the training
backward and the `gcl_fused` autograd function) and `chord_tail` (chord
decode -> unembed -> argmax)."""
