"""Kernels and their plain versions: flash attention forward and paged
decode attention (CUDA C++ in ``csrc/``), the backend registry, and the
kernel build. Submodules import lazily; nothing here loads a kernel."""
