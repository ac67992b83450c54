from .base import ARCH_IDS, PORTED_FAMILIES, ArchConfig, MoECfg, SSMCfg, get_config, reduced_config

__all__ = [
    "ARCH_IDS", "PORTED_FAMILIES", "ArchConfig", "MoECfg", "SSMCfg",
    "get_config", "reduced_config",
]
