"""PyTorch port of :mod:`repro`, for NVIDIA Hopper cards.

The package mirrors ``src/repro/`` module by module; each module here has
one counterpart there, which stays the reference its tests compare with.
It imports ``torch`` only.  The two kernels on the quantized serving path
(``kernels/quant_matmul.py`` and ``kernels/paged_attention.py``) are CUDA
C++ for ``sm_90a`` under ``kernels/csrc/``, built with ``nvcc`` at first
use; every wrapper sends a CPU tensor to its plain PyTorch version.
"""
