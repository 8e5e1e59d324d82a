"""Hand-written CUDA kernels of the port (csrc/*.cu) with their plain
PyTorch versions: K1 scan_kernel, K2 select_kernel, K3 sweep_kernel
(with the run-length pass), K4 eval_kernel, K5 sorted_serve_kernel,
K6 cubic_l1_kernel, and probe_kernels, the nine card probes.  K3 and K4
launch one C entry point per leaf family (linear, cubic, loglinear,
normal); K5 one that writes sorted answers and one that scatters them
back to their queries' places.  A wrapper
given CPU tensors
runs the plain version; given CUDA tensors it launches the kernel (built
by _build) or raises."""
