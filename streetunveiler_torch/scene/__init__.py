"""Scene state (counterpart of ``streetunveiler_tpu.scene``)."""
