from repro_torch.data.loader import DataConfig, ShardedLoader  # noqa: F401
