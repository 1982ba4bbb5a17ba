"""Device ms per iteration of the ops started inside DeepLab's backbone
(``deeplab.backbone``): its forward."""


def read(run):
    from portbench.spans import span_ms
    from portbench.spans_deeplab import DEEPLAB_BACKBONE

    return span_ms(run, DEEPLAB_BACKBONE)
