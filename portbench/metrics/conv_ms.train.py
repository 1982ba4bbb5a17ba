"""Device ms per iteration of the cuDNN convolution and GEMM kernels."""


def read(run):
    from portbench.readers import group_ms

    return group_ms(run, "conv")
