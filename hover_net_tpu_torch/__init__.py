"""hover_net_tpu_torch: the PyTorch + CUDA port of hover_net_tpu.

The JAX package `hover_net_tpu` is the reference; each module here names
its counterpart there. Plain tensor code is PyTorch (cuDNN convolutions,
torch ops); each Pallas kernel of the JAX package is a hand-written CUDA
kernel for Hopper: the post-processing tail K1, its stage-ablation
variants K4 and the standalone watershed K2 in `csrc/post_proc_tail.cu`
(bound in `ops/post_proc_cuda.py` and `ops/watershed_cuda.py`), the
fused-block encoder K3 in `csrc/fused_block.cu`
(`ops/fused_block_cuda.py`).

This package imports torch and never jax, flax or the JAX package
itself. The host modules it needs (tiling, the instance tables and their
native library, targets, remap_label, crops, QuPath export, the WSI file
handler) are its own copies, each at the JAX package's sub-path and held
against the original by tests/test_torch_host_copies.py.
"""

__version__ = "0.1.0"
