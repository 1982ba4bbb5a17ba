"""Seg2Eye in PyTorch for NVIDIA Hopper: the scored-inference path of
``seg2eye_tpu`` (the JAX package, which stays the reference) ported to
PyTorch, with the fused SPADE+Style norm as hand-written CUDA kernels
(bfloat16 on the tensor cores, float32 on the FP32 pipes).

Module names follow ``seg2eye_tpu`` so each counterpart is easy to find.
Inside, activations are logically NCHW in ``torch.channels_last`` memory
(the NHWC layout of the JAX package and of the kernel); the public
boundary (``Pix2Pix.inference``, the tester, ``ops``) keeps the JAX
package's layouts.  The port imports nothing of ``seg2eye_tpu``, at any
depth: it keeps its own copies of what it needs from there, each held to
the original by a test: ``options`` (field for field), the weight export
in ``utils.weights`` (bit for bit) and the evaluation H5 loader in
``data.openeds`` (byte for byte).
"""

__version__ = "0.1.0"
