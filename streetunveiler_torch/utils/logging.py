"""Training log (counterpart of ``TrainLogger`` in ``streetunveiler_tpu/
utils/logging.py``): scalars as JSON lines in ``train_log.jsonl``. The JAX
package's TensorBoard mirror and profiler hook are not ported; a trace of
the port comes from ``torch.profiler``."""

from __future__ import annotations

import json
import os
import time


class TrainLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "train_log.jsonl"), "a")
        self._t0 = time.time()

    def scalars(self, step: int, values: dict) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in values.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self) -> None:
        self.jsonl.close()
