from repro_torch.configs.base import (ARCH_IDS, ARCH_REGISTRY, INPUT_SHAPES,
                                     InputShape, ModelConfig, MoEConfig,
                                     SSMConfig, get_config, get_smoke_config,
                                     list_archs)

__all__ = ["ARCH_IDS", "ARCH_REGISTRY", "INPUT_SHAPES", "InputShape",
           "ModelConfig", "MoEConfig", "SSMConfig", "get_config",
           "get_smoke_config", "list_archs"]
