"""The unveil pipeline (counterpart of ``streetunveiler_tpu.pipeline``)."""
