"""rmi_tpu_torch: the learned-index engine of ``rmi_tpu`` ported to
PyTorch and hand-written CUDA kernels for an NVIDIA H100.

Builds and serves two-layer RMIs over sorted integer keys on the device
that holds them; ``rmi_tpu`` (JAX) is the reference it is tested
against.  This package imports torch and numpy, never jax.

    data = rmi_tpu_torch.load_data("books_200M_uint64", device="cuda")
    rmi = rmi_tpu_torch.train(data, "cubic,linear", 262144)
    guess, err = rmi_tpu_torch.lookup(rmi, queries)   # |guess - lb| <= err
    idx = rmi_tpu_torch.search(rmi, queries)          # exact lower bounds
    idx = rmi_tpu_torch.search_sorted(rmi, sorted_queries)   # the same, sorted

Queries and keys travel as int64 order-preserving images
(``rmi_tpu_torch.keys.to_image``).
"""

from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.data import RMIDataset, load_data, write_sosd_file
from rmi_tpu_torch.train.api import TrainedRMI, train, trained_from_numpy
from rmi_tpu_torch.lookup import lookup, search, search_sorted

__all__ = ["KeyType", "RMIDataset", "load_data", "write_sosd_file",
           "TrainedRMI", "train", "trained_from_numpy", "lookup", "search",
           "search_sorted"]
