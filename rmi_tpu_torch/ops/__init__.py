"""Hand-written CUDA kernels of the port (csrc/*.cu) with their plain
PyTorch versions: K1 scan_kernel, K2 select_kernel, K3 sweep_kernel,
K4 eval_kernel.  A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel (built by _build) or raises."""
