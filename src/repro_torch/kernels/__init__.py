"""Hand-written Hopper kernels of the port and their plain-PyTorch
versions.  ``ops`` picks between them by the device of the tensors:
CUDA launches the kernel, CPU runs ``ref``."""
