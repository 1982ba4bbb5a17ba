"""Multi-GPU training and scoring, one process per GPU, the counterpart
of ``seg2eye_tpu/parallel``: the process grid (``mesh``), data
parallelism over its data axis (``data_parallel``), tensor parallelism
over its model axis (``tensor_parallel``, ``--model_axis``) and H-band
context parallelism of scoring (``spatial``, ``--spatial_shard``)."""
