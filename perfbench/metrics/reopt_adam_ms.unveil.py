"""reopt_adam_ms.unveil: device milliseconds per delta step of the deltas'
Adam, the operations launched inside the program's ``unveil.adam`` ranges
(``make_lrs`` and ``train/optim.adam_update`` over the six delta leaves,
each as large as the whole state), over the traced window. None where the
program has no such range."""

from perfbench.spans import device_ms_per_step


def read(reading):
    if reading.kind != "unveil":
        return None
    return device_ms_per_step(reading, ("unveil.adam",))
