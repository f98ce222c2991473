"""The port's ops; ``kernel_launches`` counts its hand-written kernels'
launches in this process."""


def kernel_launches() -> dict[str, int]:
    """Each hand-written CUDA kernel's launches since import or the last
    reset to 0: ``mas_cuda.launches`` and ``grouped_conv.launches``."""
    from vits_torch.ops import grouped_conv, mas_cuda

    return {**mas_cuda.launches, **grouped_conv.launches}
