"""sky_ms.train: device milliseconds per training step of the sky, the
operations launched inside the program's ``sky.forward`` and
``sky.backward`` ranges (``models/sky.render_sky`` and its backward up to
the sky parameters' gradients), over the traced window."""

from perfbench.spans import device_ms_per_step


def read(reading):
    if reading.kind != "train":
        return None
    return device_ms_per_step(reading, ("sky.forward", "sky.backward"))
