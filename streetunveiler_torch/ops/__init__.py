"""Tensor math and the rasterizer (counterpart of ``streetunveiler_tpu.ops``)."""
