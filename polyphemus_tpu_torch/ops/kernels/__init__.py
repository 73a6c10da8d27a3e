"""Hand-written CUDA kernels, each beside its plain PyTorch version: `gcl`
(the eval GCL stack and the training forward), `gcl_bwd` (the training
backward and the `gcl_fused` autograd function) and `chord_tail` (chord
decode -> unembed -> argmax)."""


def launch_counts() -> dict:
    """Every wrapper's count of its kernel's launches in this process, by
    kernel name; `<name>_cols` counts those of them in the column form
    (tensor parallelism)."""
    from . import chord_tail, gcl, gcl_bwd

    cols = {f"{k}_cols": v for k, v in gcl.col_launches.items()}
    return {"gcl_eval": gcl.launches,
            "gcl_eval_bf16": gcl.eval_bf16_launches,
            "gcl_fwd": gcl.fwd_launches,
            "gcl_fwd_bf16": gcl.fwd_bf16_launches,
            "gcl_bwd_data": gcl_bwd.data_launches,
            "gcl_bwd_weight": gcl_bwd.weight_launches,
            "gcl_bwd_fused": gcl_bwd.fused_launches,
            "chord_tail": chord_tail.launches,
            "chord_tail_bf16": chord_tail.bf16_launches, **cols}
