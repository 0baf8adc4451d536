from repro_torch.kernels.ring_reduce.ops import ring_combine  # noqa: F401
