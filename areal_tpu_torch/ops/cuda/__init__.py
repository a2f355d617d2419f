"""Hand-written CUDA kernels (sources in ``areal_tpu_torch/csrc``) and
their wrappers. Nothing here touches the toolchain at import time."""


def launch_counts() -> dict:
    """Every wrapper's kernel-launch count in this process (a CUDA graph's
    replay credits the launches its capture recorded)."""
    from areal_tpu_torch.ops.cuda import flash_attention, fused_sample
    from areal_tpu_torch.ops.cuda import paged_attention

    return {
        "paged_decode": paged_attention.launches,
        "flash_fwd": flash_attention.fwd_launches,
        "flash_bwd": flash_attention.bwd_launches,
        "fused_sample": fused_sample.launches,
    }
