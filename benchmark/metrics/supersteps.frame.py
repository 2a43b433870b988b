"""Supersteps a frame of the window marched, as the renderer counts them
(`VNRenderer.last_stats["supersteps"]`), averaged over the window."""


def read(m):
    return m.program.get("supersteps_per_frame")
