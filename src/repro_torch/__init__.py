"""PyTorch/CUDA port of the Flare reproduction (serving slice)."""
