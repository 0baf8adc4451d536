from repro_torch.kernels.fused_norm.ops import fused_residual_rmsnorm  # noqa: F401
