"""Device ms per batch of the program's host-to-device copies of its
inputs (its ``input.to_device`` spans)."""


def read(run):
    from portbench.spans import TO_DEVICE, span_ms

    return span_ms(run, TO_DEVICE)
