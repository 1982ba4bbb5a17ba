"""The generic DeepLabV3+ trainer's CLI (VOC / SBD / COCO / Cityscapes),
the port's counterpart of ``refinenet/deeplab/train.py``:

    python -m seg2eye_tpu_torch.segtrain --dataset pascal --backbone resnet \
        [--epochs N] [--batch-size N] [--lr LR] [--loss-type ce|focal] \
        [--use-balanced-weights] [--resume CKPT] [--ft] [--no-val] \
        [--precision float32|bfloat16] [--data-root DIR] [--no-cuda]

It trains on the card; --no-cuda trains on the CPU.  Runs go to
./run/<dataset>/<checkname>/experiment_<id>.
"""
from seg2eye_tpu_torch.segtrain.trainer import main

if __name__ == "__main__":
    main()
