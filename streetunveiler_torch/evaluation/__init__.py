"""Evaluation (counterpart of ``streetunveiler_tpu.evaluation``)."""
