from repro_torch.data.pipeline import DataConfig, Prefetcher, host_batch

__all__ = ["DataConfig", "Prefetcher", "host_batch"]
