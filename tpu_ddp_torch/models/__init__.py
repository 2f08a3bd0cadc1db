from tpu_ddp_torch.models import vit  # noqa: F401  (registers vit_s4, vit_b16)
from tpu_ddp_torch.models.lm import CausalTransformerLM, greedy_generate
from tpu_ddp_torch.models.resnet import BatchNorm, NetResDeep, ResBlock, param_count
from tpu_ddp_torch.models.vit import ViT, full_attention
from tpu_ddp_torch.models.zoo import MODEL_REGISTRY, register

__all__ = ["BatchNorm", "NetResDeep", "ResBlock", "param_count", "ViT",
           "full_attention", "CausalTransformerLM", "greedy_generate",
           "MODEL_REGISTRY", "register"]
