"""view_idle_ms.render: the median over the program's ``view`` ranges
(``cli/render.render_view``, up to its return, before the outputs' copy to
the host) of each range's length less the union of the card's busy
intervals inside it, in milliseconds, over the traced window: the card's
idle time inside the program's view, apart from the harness's copy."""

from perfbench.spans import median_idle_ms


def read(reading):
    if reading.kind != "render":
        return None
    return median_idle_ms(reading.tracer, "view")
