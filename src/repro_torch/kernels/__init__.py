"""Hand-written Hopper (sm_90a) kernels of the port and their routing.

``csrc/`` holds the CUDA C++ sources; ``build`` compiles and binds them;
each kernel module holds its wrapper (kernel on CUDA tensors, plain
version from ``ref`` on CPU tensors, a ``.launches`` counter);
``dispatch`` routes the serving layouts to them.
"""
