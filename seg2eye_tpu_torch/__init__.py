"""Seg2Eye in PyTorch for NVIDIA Hopper: the scored-inference path of
``seg2eye_tpu`` (the JAX package, which stays the reference) ported to
PyTorch, with the fused SPADE+Style norm as a hand-written CUDA kernel.

Module names follow ``seg2eye_tpu`` so each counterpart is easy to find.
Inside, activations are logically NCHW in ``torch.channels_last`` memory
(the NHWC layout of the JAX package and of the kernel); the public
boundary (``Pix2Pix.inference``, the tester, ``ops``) keeps the JAX
package's layouts.  ``options`` mirrors the JAX package's options field
for field, so that inference on the card loads nothing of
``seg2eye_tpu``.  Two framework-free host modules of ``seg2eye_tpu`` are
imported inside the functions that need them, never at module level: the
weight exporter (``utils.weights.from_jax_variables``) and the H5 loader
(the CLI's ``make_dataloader``); neither pulls in ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
