"""Host time a training step spends in `NeuralVolume.train`: the
harness's host-clock span around each call of the window, per step."""


def read(m):
    calls = m.spans.total("train_call")
    if not calls or not m.units:
        return None
    return calls / m.units * 1e3
