"""Import side-effect module: registers the architecture configs the port
serves: llama3.1-8b, llama3.1-70b, gemma2-2b, qwen2-1.5b, chatglm3-6b,
qwen3-32b and mamba2-2.7b so far; the other archs join as their model
paths are ported (ROADMAP.md, queue A)."""
from repro_torch.configs import chatglm3_6b  # noqa: F401
from repro_torch.configs import gemma2_2b  # noqa: F401
from repro_torch.configs import llama3_1_8b  # noqa: F401
from repro_torch.configs import llama3_1_70b  # noqa: F401
from repro_torch.configs import mamba2_2_7b  # noqa: F401
from repro_torch.configs import qwen2_1_5b  # noqa: F401
from repro_torch.configs import qwen3_32b  # noqa: F401
