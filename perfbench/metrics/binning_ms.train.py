"""binning_ms.train: device milliseconds per training step of the
operations launched inside the ``bin_step`` ranges the harness opens
around each call ``train.loop.train_scene`` makes to ``train.step.
bin_step`` (the steps' binning and each chunk's capacity probe), over the
traced window."""


def read(reading):
    if reading.kind != "train" or not reading.steps \
            or "bin_step" not in reading.tracer.spans:
        return None
    seconds = reading.tracer.device_s_in_spans("bin_step")
    if seconds <= 0:
        return None
    return 1e3 * seconds / reading.steps
