from .base import (ARCH_IDS, SHAPES, SUBQUADRATIC, ModelConfig, arch_shapes,
                   get_config)

__all__ = ["ARCH_IDS", "SHAPES", "SUBQUADRATIC", "ModelConfig",
           "arch_shapes", "get_config"]
