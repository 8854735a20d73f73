"""Models: the Llama-family decoder (dense-cache serving subset)."""
from skypilot_tpu_torch.models.llama import (LLAMA_CONFIGS, Llama,
                                             LlamaConfig, init_params)

__all__ = ['LLAMA_CONFIGS', 'Llama', 'LlamaConfig', 'init_params']
