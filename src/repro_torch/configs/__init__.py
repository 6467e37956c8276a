from repro_torch.configs.base import (
    ARCH_IDS,
    BACKEND_NAMES,
    PORTED_ARCHS,
    ModelConfig,
    MoEConfig,
    ParallelConfig,
    RGLRUConfig,
    SpammConfig,
    SSMConfig,
    TrainConfig,
    get_config,
)
