from repro_torch.configs.base import LayerSpec, ModelConfig, get_config, list_archs  # noqa: F401
from repro_torch.configs.reduced import reduce_config  # noqa: F401
