"""Host time a frame spends in `VNRenderer.render` (the harness's
host-clock span around each call of the window; the frame's readback in
`mapframe` is not in it)."""


def read(m):
    s = m.spans.total("render")
    if not s or not m.units:
        return None
    return s / m.units * 1e3
