"""Hand-written CUDA kernels, each beside its plain PyTorch version: `gcl`
(the eval GCL stack and the training forward), `gcl_bwd` (the training
backward and the `gcl_fused` autograd function) and `chord_tail` (chord
decode -> unembed -> argmax); `counts` holds their launch counts."""

# the wrappers' kernel names, each counted at bars of 4 x 32 cells
KERNELS = ("gcl_eval", "gcl_eval_bf16", "gcl_fwd", "gcl_fwd_bf16",
           "gcl_bwd_data", "gcl_bwd_weight", "gcl_bwd_fused", "chord_tail",
           "chord_tail_bf16")


def launch_counts() -> dict:
    """Every wrapper's count of its kernel's launches in this process, by
    kernel name, over any number of chained layers: the names alone count
    launches at bars of 4 x 32 cells, `<name>_s<S>` those at 4 x S (another
    resolution) and `<name>_cols` those in the column form (tensor
    parallelism) among them."""
    from . import counts, gcl

    out = dict.fromkeys(KERNELS, 0)
    for (kernel, s, _), n in counts.launches.items():
        name = kernel if s == 32 else f"{kernel}_s{s}"
        out[name] = out.get(name, 0) + n
    out.update((f"{k}_cols", v) for k, v in gcl.col_launches.items())
    return out
