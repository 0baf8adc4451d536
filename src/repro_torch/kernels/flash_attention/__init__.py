from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
