from repro_torch.kernels.padded_matmul.ops import padded_matmul  # noqa: F401
