"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

``paged_decode`` — paged flash decode (CUDA C++, ``csrc/paged_decode.cu``);
``build`` — nvcc build of ``csrc/*.cu`` at first use, loaded with ctypes;
``ops`` — public entries with the JAX package's argument checks, dispatching
CPU tensors to the plain version and CUDA tensors to the kernel.
"""
