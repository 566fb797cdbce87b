from dpfx_torch.config.schema import (
    Config,
    DataConfig,
    EncoderConfig,
    EvalConfig,
    FlowConfig,
    ImageEncoderConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
    config_from_dict,
    load_config,
)

__all__ = [
    "Config",
    "DataConfig",
    "EncoderConfig",
    "EvalConfig",
    "FlowConfig",
    "ImageEncoderConfig",
    "ModelConfig",
    "ParallelConfig",
    "TrainConfig",
    "config_from_dict",
    "load_config",
]
