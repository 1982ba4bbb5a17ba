"""Device ms per iteration launched inside the training steps' optimizer
spans (gradient all-reduce, clip, the optimizer's step, buffer
broadcast)."""


def read(run):
    from portbench.spans import OPTIMIZER, span_ms

    return span_ms(run, OPTIMIZER)
