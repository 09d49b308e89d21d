"""PyTorch/CUDA port of the dehazing framework, for NVIDIA Hopper (sm_90a).

Mirrors the paths and names of the JAX package `dehaze_tpu/`, which stays the
reference: each module here has its counterpart at the same relative path.
The port imports torch, numpy and the standard library only — never jax,
flax or `dehaze_tpu`.

Kernels: `ops/kernels/window_attention.py` (K1, ProbSparse window attention,
forward and backward, a `torch.autograd.Function`, and K3, the older
variants of the same chain) and `ops/kernels/leff.py` (K2, fused LayerNorm +
LeFF, inference) launch hand-written CUDA C++ from `csrc/` on CUDA tensors
and run their plain torch twins on CPU tensors. Dispatch is by device only.

Paths: whole-image serving (`infer/tiled.py`, `cli/serve.py`), evaluation
(`infer/anyres.py`, `cli/test_long.py`, `cli/test_anyres.py`) and training
(`train/`, `cli/train.py`), for the Uformer and, as cuDNN convolutions
with no kernel of their own, FFA-Net (`models/ffa.py`, `cli/ffa_train.py`,
the native-resolution protocol) and the conv UNet (`models/unet.py`); and
the analysis stack: loss landscapes (`ops/landscape.py`, `cli/landscape.py`,
`cli/landscape_pair.py`, through the eval forward and its kernels),
optimization trajectories (`ops/trajectory.py`), training curves, FLOP
counts (`utils/flops.py`) and the host monitor.
"""
