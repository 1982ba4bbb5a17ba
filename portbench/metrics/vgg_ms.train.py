"""Device ms per iteration of the ops started inside the VGG loss's
forward (``loss.vgg``: fake and real through VGG19 and the weighted L1);
its backward's kernels start inside ``train.backward``."""


def read(run):
    from portbench.spans import span_ms
    from portbench.spans_gaugan import LOSS_VGG

    return span_ms(run, LOSS_VGG)
