"""reopt_deltas_ms.unveil: device milliseconds per delta step of
``models/deltas.apply_deltas`` (base + delta·mask over every row of the
six leaves) and of its backward (delta gradient = effective gradient ·
mask), the operations launched inside the program's ``unveil.deltas`` and
``unveil.deltas_bwd`` ranges, over the traced window. None where the
program has no such range."""

from perfbench.spans import device_ms_per_step


def read(reading):
    if reading.kind != "unveil":
        return None
    return device_ms_per_step(reading, ("unveil.deltas",
                                        "unveil.deltas_bwd"))
