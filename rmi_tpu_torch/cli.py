"""Command-line entry point, the reference CLI's surface (src/main.rs:36-102;
counterpart of rmi_tpu/cli.py):

    python -m rmi_tpu_torch <input> [namespace] [models] [branching_factor]
        [--no-code] [--no-errors] [--bounded LINE] [--param-grid FILE]
        [--data-path DIR] [--threads N] [--zero-build-time]
        [--disable-parallel-training] [--dump-ll-model-data IDX]
        [--dump-ll-errors] [--stats-file F] [--max-size BYTES]
        [--optimize FILE]

It trains on the card, then writes the artifact under ``--data-path``
and the C++ sources into the working directory, as rmi_tpu's CLI writes
them.  The key type follows the file name (``uint64``, ``uint32`` or
``f64`` in it); ``--bounded`` on f64 keys raises ValueError, as
rmi_tpu's does (RMIDataset.as_u64).  ``--param-grid`` trains its
configurations one at a time on the card (``--disable-parallel-training``
is accepted and changes nothing: rmi_tpu's device pool,
parallel/sweep.py, is not ported).
``--threads`` is accepted for the reference's sake.  ``--optimize`` and
``--max-size`` need the optimizer, which is not ported: they exit with 1.
``main(argv, device="cpu")`` runs the same on the CPU, as the tests do.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

log = logging.getLogger("rmi_tpu_torch")

OPTIMIZER_MISSING = ("needs the Pareto optimizer, which rmi_tpu_torch does not "
                     "have yet (ROADMAP.md Queue 1, item 2: the optimizer)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rmi_tpu_torch",
        description="Learns recursive model indexes on a CUDA card")
    p.add_argument("input", help="Path to input file containing data")
    p.add_argument("namespace", nargs="?",
                   help="Namespace to use in generated code")
    p.add_argument("models", nargs="?",
                   help="Comma-separated model layers, e.g. linear,linear")
    p.add_argument("branching_factor", nargs="?", type=int,
                   help="Branching factor between model levels")
    p.add_argument("--no-code", action="store_true",
                   help="Skip code generation")
    p.add_argument("--dump-ll-model-data", metavar="model_index", type=int,
                   help="dump the data used to train the last-level model "
                        "at index")
    p.add_argument("--dump-ll-errors", action="store_true",
                   help="dump per-leaf errors to ll_errors.json")
    p.add_argument("--stats-file", "-s", metavar="file",
                   help="dump statistics about the learned model")
    p.add_argument("--param-grid", metavar="file",
                   help="train RMIs specified in the JSON file")
    p.add_argument("--data-path", "-d", metavar="dir", default="rmi_data",
                   help="export parameters to this directory")
    p.add_argument("--no-errors", action="store_true",
                   help="do not save last-level errors; changes the "
                        "lookup signature")
    p.add_argument("--threads", "-t", type=int, default=4,
                   help="host thread count (kept for the reference's CLI; "
                        "builds run on the card)")
    p.add_argument("--bounded", metavar="line_size", type=int,
                   help="error-bounded RMI via cachefix for the line size")
    p.add_argument("--max-size", metavar="BYTES", type=int,
                   help="optimizer-driven size-bounded RMI (not ported)")
    p.add_argument("--disable-parallel-training", action="store_true",
                   help="train --param-grid configs one at a time (they "
                        "always are)")
    p.add_argument("--zero-build-time", action="store_true",
                   help="zero the build-time field in artifacts")
    p.add_argument("--optimize", metavar="file",
                   help="search Pareto-efficient configs (not ported)")
    return p


def result_json(trained, num_rows, namespace):
    """The statistics of one build (src/main.rs:207-221; its "average
    error %" is the max error's, as there)."""
    from rmi_tpu_torch.serialize import rmi_size
    return {
        "layers": trained.models,
        "branching factor": trained.branching_factor,
        "average error": trained.model_avg_error,
        "average error %": trained.model_max_error / num_rows * 100.0,
        "average l2 error": trained.model_avg_l2_error,
        "average log2 error": trained.model_avg_log2_error,
        "max error": trained.model_max_error,
        "max error %": trained.model_max_error / num_rows * 100.0,
        "max log2 error": trained.model_max_log2_error,
        "size binary search": rmi_size(trained),
        "namespace": namespace,
    }


def _param_grid(args, data) -> int:
    from rmi_tpu_torch import output_rmi, train
    with open(args.param_grid) as f:
        grid = json.load(f)["configs"]
    to_test = [(c["layers"], int(c["branching factor"]), c.get("namespace"))
               for c in grid]
    log.info("# RMIs to train: %d", len(to_test))
    results = []
    for i, (models, bf, ns) in enumerate(to_test):
        log.info("[%d/%d] training %s %d", i + 1, len(to_test), models, bf)
        trained = train(data, models, bf)
        if args.zero_build_time:
            trained.build_time = 0
        results.append(result_json(trained, data.n, ns))
        if ns is not None:
            output_rmi(ns, trained, data_dir=args.data_path, include_errors=True,
                       emit_cpp=not args.no_code)
    with open(f"{args.param_grid}_results", "w") as f:
        json.dump({"results": results}, f)
    return 0


def _dump_ll_model_data(trained, data, idx: int) -> None:
    """The (key, FixDups position) pairs the top routes to leaf ``idx``."""
    from rmi_tpu_torch import keys as keymod
    from rmi_tpu_torch.models import get_model
    from rmi_tpu_torch.train import two_layer
    t = two_layer.top_assignment(get_model(trained.top_type), trained.device_top_params,
                                 data.keys, trained.norm_offset, trained.norm_scale,
                                 trained.branching_factor - 1, data.key_type)
    mask = t == idx
    ks = keymod.from_image(data.keys[mask], data.key_type)
    ys = two_layer.fixdups_i32(data.keys)[mask].cpu().numpy()
    with open(f"ll_model_data_{idx}.json", "w") as f:
        json.dump({"keys": ks.tolist(), "positions": ys.tolist()}, f)


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (sys.argv when None), training on
    ``device``: the card when None, the CPU only when asked for."""
    logging.basicConfig(
        # RMI_LOG is a logging level name (DEBUG, INFO, ...); "1" means DEBUG
        level={"1": "DEBUG", "0": "WARNING"}.get(
            os.environ.get("RMI_LOG", "INFO"), os.environ.get("RMI_LOG", "INFO")).upper(),
        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)

    from rmi_tpu_torch import load_data, output_rmi, train, train_bounded

    if args.namespace and args.param_grid:
        log.error("Can only specify one of namespace or param-grid")
        return 1
    if args.optimize or args.max_size is not None:
        log.error("--%s %s", "optimize" if args.optimize else "max-size",
                  OPTIMIZER_MISSING)
        return 1

    log.info("Reading %s...", args.input)
    data = load_data(args.input, device=device)
    num_rows = data.n
    os.makedirs(args.data_path, exist_ok=True)
    if args.param_grid:
        return _param_grid(args, data)
    if not args.namespace:
        log.error("Must specify either a namespace or a parameter grid.")
        return 1
    if not args.models or args.branching_factor is None:
        log.error("namespace mode needs models and branching factor")
        return 1
    if args.bounded is not None:
        trained = train_bounded(data, args.models, args.branching_factor, args.bounded)
    else:
        trained = train(data, args.models, args.branching_factor)

    log.info("Model build time: %d ms", trained.build_time // 1_000_000)
    log.info("Average model error: %s (%s%%)", trained.model_avg_error,
             trained.model_avg_error / num_rows * 100.0)
    log.info("Average model L2 error: %s", trained.model_avg_l2_error)
    log.info("Average model log2 error: %s", trained.model_avg_log2_error)
    log.info("Max model log2 error: %s", trained.model_max_log2_error)
    log.info("Max model error on model %d: %d (%s%%)",
             trained.model_max_error_idx, trained.model_max_error,
             trained.model_max_error / num_rows * 100.0)

    if args.stats_file:
        with open(args.stats_file, "w") as f:
            json.dump(result_json(trained, num_rows, args.namespace), f, indent=1)
    if args.dump_ll_errors:
        with open("ll_errors.json", "w") as f:
            json.dump({"errors": trained.leaf_errors.cpu().tolist()}, f)
    if args.dump_ll_model_data is not None:
        _dump_ll_model_data(trained, data, args.dump_ll_model_data)
    if args.zero_build_time:
        trained.build_time = 0
    if not args.no_code:
        output_rmi(args.namespace, trained, data_dir=args.data_path,
                   include_errors=not args.no_errors)
    else:
        log.debug("Skipping code generation due to CLI flag")
    return 0


if __name__ == "__main__":
    sys.exit(main())
