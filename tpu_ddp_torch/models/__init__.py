from tpu_ddp_torch.models import moe, resnet_family, vit  # noqa: F401  (fill the registry)
from tpu_ddp_torch.models.lm import CausalTransformerLM, greedy_generate
from tpu_ddp_torch.models.moe import MoEViT
from tpu_ddp_torch.models.resnet import BatchNorm, NetResDeep, ResBlock, param_count
from tpu_ddp_torch.models.resnet_family import ResNet, WideResNet
from tpu_ddp_torch.models.vit import ViT, full_attention
from tpu_ddp_torch.models.zoo import MODEL_REGISTRY, register

__all__ = ["BatchNorm", "NetResDeep", "ResBlock", "param_count", "ViT",
           "full_attention", "MoEViT", "ResNet", "WideResNet", "CausalTransformerLM", "greedy_generate",
           "MODEL_REGISTRY", "register"]
