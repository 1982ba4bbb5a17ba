"""Multi-GPU training: data parallelism over processes, one per GPU
(``data_parallel``), the counterpart of ``seg2eye_tpu/parallel``.  The
JAX package's tensor-parallel (``--model_axis > 1``) and H-band
(``--spatial_shard``) forms are not ported."""
