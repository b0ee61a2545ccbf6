from repro_torch.configs.base import (
    EncDecConfig,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    XLSTMConfig,
    get_model_config,
    list_archs,
    parse_cli,
    register,
)

__all__ = [k for k in dir() if not k.startswith("_")]
