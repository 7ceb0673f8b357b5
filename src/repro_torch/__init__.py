"""PyTorch/CUDA port of the packing-prefetch serving system.

A second package beside the JAX reference (``src/repro``). It imports
``torch`` and numpy only — never JAX and never the JAX package; host-side
modules it needs are carried as copies that ``tests/test_torch_isolation.py``
holds to their originals. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
