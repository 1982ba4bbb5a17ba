#!/usr/bin/env python3
"""Build the nearest-neighbour style-ranking H5 (distances_and_indices)
with the PyTorch port, on a CUDA card (``--device cpu`` for the CPU).
The port's counterpart of ``tools/build_style_ranking.py``, with its flags;
see ``seg2eye_tpu_torch/data/style_ranking.py``.

    python tools/build_style_ranking_torch.py --dataroot data.h5 \\
        --segmentations_generative segs_gen.h5 \\
        --segmentations_sequence segs_seq.h5 \\
        --out distances_and_indices.h5 [--splits train,validation] \\
        [--top_k 100] [--device cuda]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from seg2eye_tpu_torch.data.style_ranking import main  # noqa: E402

if __name__ == "__main__":
    main()
