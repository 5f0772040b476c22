"""Continuous-batching serving over a paged, LQ-quantized KV pool."""
