from .dataset import ShardCache
from .loader import BatchIterator, DevicePrefetcher
from .sampler import BalancedBatchSampler, ShuffleBatchSampler

__all__ = ["BalancedBatchSampler", "BatchIterator", "DevicePrefetcher", "ShardCache",
           "ShuffleBatchSampler"]
