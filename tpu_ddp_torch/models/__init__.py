from tpu_ddp_torch.models.resnet import BatchNorm, NetResDeep, ResBlock, param_count

__all__ = ["BatchNorm", "NetResDeep", "ResBlock", "param_count"]
