from tpu_ddp_torch.data.cifar10 import (
    load_cifar10,
    load_cifar100,
    normalize,
    synthetic_cifar10,
    synthetic_cifar10_hard,
    synthetic_multilabel,
)
from tpu_ddp_torch.data.loader import ShardedBatchLoader, shard_indices

__all__ = ["load_cifar10", "load_cifar100", "normalize", "synthetic_cifar10",
           "synthetic_cifar10_hard", "synthetic_multilabel",
           "ShardedBatchLoader", "shard_indices"]
