"""Training: the optimizers (``state``), one iteration (``steps``), the
epoch loop (``loop``) and the CLI (``python -m seg2eye_tpu_torch.train``)."""
