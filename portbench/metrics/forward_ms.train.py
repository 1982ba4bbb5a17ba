"""Device ms per iteration launched inside the training steps' forward
spans (the forward and loss; Seg2Eye's D step with its regenerated fake)."""


def read(run):
    from portbench.spans import FORWARD, span_ms

    return span_ms(run, FORWARD)
