"""The RefineNet system on PyTorch (counterpart of ``seg2eye_tpu/refinenet``):
the DeepLabV3+ SegNet that predicts 4-class eye masks, and the DeepLabV3+
RefineNet that refines a nearest-neighbour image toward a target mask;
their datasets, trainer and CLIs."""
