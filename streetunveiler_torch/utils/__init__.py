"""Utilities (counterpart of ``streetunveiler_tpu.utils``)."""
