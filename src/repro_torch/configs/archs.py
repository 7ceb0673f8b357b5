"""Import side-effect module: registers the architecture configs the port
serves. Only llama3.1-8b so far; the other archs join as their model paths
are ported (ROADMAP.md, queue A)."""
from repro_torch.configs import llama3_1_8b  # noqa: F401
