"""The benchmark of streetunveiler_torch on an NVIDIA H100: run a cell with
``python3 -m perfbench.run`` (see ``run.py``, ``harness.py``)."""
