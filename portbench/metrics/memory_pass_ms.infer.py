"""Device ms per batch of the memory passes: batch norms, activations,
elementwise ops and reductions (every kernel not a conv, GEMM, K1 or copy)."""


def read(run):
    from portbench.readers import group_ms

    return group_ms(run, "memory_pass")
