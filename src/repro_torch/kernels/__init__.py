"""Kernels of the quantized serving path and their plain versions.

  quant_matmul     fused unpack + dequant + matmul over packed LQ weights
                   (csrc/quant_matmul.cu)
  paged_attention  flash-decode over wire-format KV pages with in-register
                   dequant (csrc/paged_attention.cu)
  act_quant        runtime activation quantization per row and local
                   region, codes packed along K (csrc/act_quant.cu)
  lut_matmul       the paper's section-V table-lookup matmul over
                   activation codes and f32 weights (csrc/lut_matmul.cu)

``ref.py`` holds the plain weight-format arithmetic, ``ops.py`` the
``QWeight`` format and the public entry points, ``build.py`` the nvcc
build and ctypes loading.
"""


def wrappers() -> dict:
    """Every kernel's wrapper by name; each carries its ``launches``
    count, which only a kernel launch raises."""
    from . import act_quant, lut_matmul, paged_attention, quant_matmul
    return {"quant_matmul": quant_matmul.quant_matmul,
            "paged_attention": paged_attention.paged_attention,
            "act_quant": act_quant.act_quant,
            "lut_matmul": lut_matmul.lut_matmul}
