"""Model state (counterpart of ``streetunveiler_tpu.models``)."""
