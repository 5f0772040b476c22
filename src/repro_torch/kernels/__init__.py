"""Kernels of the quantized serving path and their plain versions.

  quant_matmul     fused unpack + dequant + matmul over packed LQ weights
                   (csrc/quant_matmul.cu)
  paged_attention  flash-decode over wire-format KV pages with in-register
                   dequant (csrc/paged_attention.cu)

``ref.py`` holds the plain weight-format arithmetic, ``ops.py`` the
``QWeight`` format and the public entry points, ``build.py`` the nvcc
build and ctypes loading.
"""
