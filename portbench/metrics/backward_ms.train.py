"""Device ms per iteration launched inside the training steps' backward
spans, the autograd engine's device thread included."""


def read(run):
    from portbench.spans import BACKWARD, span_ms

    return span_ms(run, BACKWARD)
