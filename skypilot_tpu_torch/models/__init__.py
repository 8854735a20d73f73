"""Models: the Llama-family decoder (with mixture-of-experts blocks), the
encoder classifier and ResNet."""
from skypilot_tpu_torch.models.encoder import (ENCODER_CONFIGS,
                                               EncoderClassifier,
                                               EncoderConfig)
from skypilot_tpu_torch.models.llama import (LLAMA_CONFIGS, Llama,
                                             LlamaConfig, init_params)
from skypilot_tpu_torch.models.moe import MoEMLP
from skypilot_tpu_torch.models.resnet import (RESNET_CONFIGS, ResNet,
                                              ResNetConfig)

__all__ = ['ENCODER_CONFIGS', 'EncoderClassifier', 'EncoderConfig',
           'LLAMA_CONFIGS', 'Llama', 'LlamaConfig', 'MoEMLP',
           'RESNET_CONFIGS', 'ResNet', 'ResNetConfig', 'init_params']
