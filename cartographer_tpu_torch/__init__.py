"""cartographer_tpu_torch: the PyTorch and CUDA port of cartographer_tpu.

The 2D local-SLAM frontend (`mapping.local_trajectory_builder_2d`) runs on an
NVIDIA Hopper card through four hand-written CUDA kernels (`csrc/`), with a
plain PyTorch twin of each kernel for CPU tensors.
"""
