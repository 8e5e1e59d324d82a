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
    rmi_tpu_torch.output_rmi("books", rmi)   # rmi_data/ blobs, books.{h,cpp}
    rmi = rmi_tpu_torch.load_artifact("rmi_data/books.json", keys=data.keys)
    front = rmi_tpu_torch.find_pareto_efficient_configs(data)   # RMIStatistics
    rmi = rmi_tpu_torch.train_for_size(data, 50_000_000)        # < 50 MB

    python -m rmi_tpu_torch books_200M_uint64 books cubic,linear 262144
    python -m rmi_tpu_torch books_200M_uint64 --optimize front.json

Queries and keys travel as int64 order-preserving images
(``rmi_tpu_torch.keys.to_image``).
"""

from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.data import RMIDataset, load_data, write_sosd_file
from rmi_tpu_torch.train.api import (TrainedRMI, train, train_bounded, train_for_size,
                                     trained_from_numpy)
from rmi_tpu_torch.lookup import lookup, lookup_and_search, search, search_sorted
from rmi_tpu_torch.optimizer import RMIStatistics, find_pareto_efficient_configs
from rmi_tpu_torch.serialize import load_artifact, output_rmi, rmi_size, save_artifact

__all__ = ["KeyType", "RMIDataset", "load_data", "write_sosd_file",
           "TrainedRMI", "train", "train_for_size", "train_bounded",
           "trained_from_numpy", "lookup", "search", "search_sorted",
           "lookup_and_search", "find_pareto_efficient_configs", "RMIStatistics",
           "output_rmi", "save_artifact", "load_artifact", "rmi_size"]
