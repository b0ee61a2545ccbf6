from repro_torch.configs.base import (
    EncDecConfig,
    MeshConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    RunConfig,
    SHAPES,
    SMOKE_SHAPES,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    XLSTMConfig,
    apply_overrides,
    get_model_config,
    get_shape,
    list_archs,
    parse_cli,
    register,
)

__all__ = [k for k in dir() if not k.startswith("_")]
