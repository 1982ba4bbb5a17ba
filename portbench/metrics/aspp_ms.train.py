"""Device ms per iteration of the ops started inside DeepLab's ASPP
(``deeplab.aspp``): its forward, the four branches, the image pooling,
the projection and the dropout."""


def read(run):
    from portbench.spans import span_ms
    from portbench.spans_deeplab import DEEPLAB_ASPP

    return span_ms(run, DEEPLAB_ASPP)
