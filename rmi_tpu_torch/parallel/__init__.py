"""Work spread over the CUDA cards of one host: parallel/sweep.py, the
optimizer's and ``--param-grid``'s device pool."""
