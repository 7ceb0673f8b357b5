"""Import side-effect module: registers the architecture configs the port
serves: every arch the JAX package registers (llama3.1-8b, llama3.1-70b,
gemma2-2b, qwen2-1.5b, chatglm3-6b, qwen3-32b, qwen3-moe-30b-a3b,
deepseek-v2-236b, mamba2-2.7b, jamba-v0.1-52b, whisper-small and
internvl2-76b)."""
from repro_torch.configs import chatglm3_6b  # noqa: F401
from repro_torch.configs import deepseek_v2_236b  # noqa: F401
from repro_torch.configs import gemma2_2b  # noqa: F401
from repro_torch.configs import internvl2_76b  # noqa: F401
from repro_torch.configs import jamba_v0_1_52b  # noqa: F401
from repro_torch.configs import llama3_1_8b  # noqa: F401
from repro_torch.configs import llama3_1_70b  # noqa: F401
from repro_torch.configs import mamba2_2_7b  # noqa: F401
from repro_torch.configs import qwen2_1_5b  # noqa: F401
from repro_torch.configs import qwen3_32b  # noqa: F401
from repro_torch.configs import qwen3_moe_30b_a3b  # noqa: F401
from repro_torch.configs import whisper_small  # noqa: F401
