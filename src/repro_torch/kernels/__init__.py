"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``).  A wrapper given CUDA tensors launches its kernel
(or raises); given CPU tensors it runs the plain version."""
