"""hover_net_tpu_torch: the PyTorch + CUDA port of hover_net_tpu.

The JAX package `hover_net_tpu` is the reference; each module here names
its counterpart there. Plain tensor code is PyTorch (cuDNN convolutions,
torch ops); the one Pallas kernel on the tile-inference path, the
post-processing tail, is a hand-written CUDA kernel for Hopper
(`csrc/post_proc_tail.cu`, bound in `ops/post_proc_cuda.py`).

This package imports torch and never jax or flax. It shares the JAX
package's jax-free host modules (tiling, instance tables and the native
tracer, targets, metrics, crops, QuPath export) as they are.
"""

__version__ = "0.1.0"
