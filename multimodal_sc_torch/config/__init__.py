from multimodal_sc_torch.config.configs import (
    CameraCodecConfig,
    ChannelConfig,
    EnvConfig,
    ExperimentConfig,
    FusionConfig,
    LidarCodecConfig,
    MeshConfig,
    RLConfig,
    TrainConfig,
)
from multimodal_sc_torch.config.presets import PRESETS, get_preset
