from tpu_ddp_torch.data.cifar10 import load_cifar10, normalize, synthetic_cifar10
from tpu_ddp_torch.data.loader import ShardedBatchLoader, shard_indices

__all__ = ["load_cifar10", "normalize", "synthetic_cifar10",
           "ShardedBatchLoader", "shard_indices"]
