from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    ARCH_MODULES,
    SHAPES,
    GroupSpec,
    LayerSpec,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
    reduced_config,
    register,
)
