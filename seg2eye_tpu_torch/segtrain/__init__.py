"""The generic DeepLabV3+ segmentation trainer on PyTorch (counterpart of
``seg2eye_tpu/segtrain``; reference: the upstream jfzhang95 VOC/SBD/COCO/
Cityscapes trainer, refinenet/deeplab/train.py, utils/ and dataloaders/):
a host-side numpy/PIL data pipeline feeding NHWC batches, the port's
``DeepLab`` on one card, SGD with the 10x head, the confusion-matrix
evaluator and the run directory of the reference.  The CLI is
``python -m seg2eye_tpu_torch.segtrain``."""
