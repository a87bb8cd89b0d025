"""Hand-written CUDA kernels, each beside its plain PyTorch twin.

A wrapper takes the twin only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""
