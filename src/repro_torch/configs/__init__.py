from repro_torch.configs.base import (ALL_SHAPES, SHAPES, ModelConfig,  # noqa
                                      ShapeConfig, get_config, list_archs)
