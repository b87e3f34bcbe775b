# The model stack (serving and training): config-driven decoder LM with RG-LRU and
# RWKV-6 recurrent blocks and windowed attention (port of repro.models).
from .config import ModelConfig
from .model import Model

__all__ = ["ModelConfig", "Model"]
