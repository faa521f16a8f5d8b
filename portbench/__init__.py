"""The benchmark of the PyTorch/CUDA port (``pointvit_tpu_torch``) on one
NVIDIA H100: cells of a model configuration under a traffic mix, each run by
``python3 -m portbench.run``, checked against the plain f32 reference in
``portbench/reference``. It imports nothing of JAX or of the JAX package."""
