"""PyTorch/CUDA port of theroundtaible_tpu: the same serving stack on an
NVIDIA Hopper card, with hand-written CUDA kernels in place of the JAX
package's Pallas TPU kernels. It imports torch and numpy, never jax and
nothing of theroundtaible_tpu, which stays in the repository as the
reference it is tested against."""
