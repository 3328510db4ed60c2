from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ArchConfig, MoEConfig, RecurrentConfig, ShapeConfig,
    shape_applicable)
