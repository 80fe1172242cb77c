from .int4 import approx_linear, dequantize, quantize_int4, quantize_intb

__all__ = ["quantize_int4", "quantize_intb", "approx_linear", "dequantize"]
