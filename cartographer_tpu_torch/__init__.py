"""cartographer_tpu_torch: the PyTorch and CUDA port of cartographer_tpu.

2D SLAM runs on an NVIDIA Hopper card through `mapping.map_builder.MapBuilder`:
the local-SLAM frontend (`mapping.local_trajectory_builder_2d`), loop closure
(`mapping.constraint_builder_2d`) and the pose graph with its Schur SPA
(`mapping.pose_graph_2d`), carried by eight hand-written CUDA kernels
(`csrc/`), each with a plain PyTorch twin for CPU tensors.
"""
