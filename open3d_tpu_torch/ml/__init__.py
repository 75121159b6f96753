"""open3d_tpu_torch.ml: the 3D machine-learning ops (port of open3d_tpu/ml/).

Plain PyTorch functions on the device of their input tensors; gradients
come from autograd wherever the JAX package's come from jax.grad.
"""

from open3d_tpu_torch.ml import ops  # noqa: F401
