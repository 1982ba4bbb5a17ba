"""K1's weight packings per iteration: the program records each packing
as one ``seg2eye.k1_pack`` span."""


def read(run):
    from portbench.spans import K1_PACK, span_count

    return span_count(run, K1_PACK)
