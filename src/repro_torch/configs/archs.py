"""Import side-effect module: registers the architecture configs the port
serves: llama3.1-8b and mamba2-2.7b so far; the other archs join as their
model paths are ported (ROADMAP.md, queue A)."""
from repro_torch.configs import llama3_1_8b  # noqa: F401
from repro_torch.configs import mamba2_2_7b  # noqa: F401
