"""Drive rmi_tpu_torch once on one CUDA card and check every kernel.

    python3 chip_smoke.py              # 200M keys, all eleven paths
    python3 chip_smoke.py --n 2000000  # a shorter run

Phases (any failure raises and exits non-zero):
  1. the card: name and power limit as nvidia-smi reports them;
  2. the kernels: built from csrc/ with nvcc and, for the binding,
     the host compiler, each step's build time printed;
  3. path 1 on books-like u64 keys made on the card from a seed:
     ``train(data, "cubic,linear", 262144)`` cold and warm (each path's
     and zoo row's RMI_SIZE logged beside its max_err), then lookup,
     search of 2^22 random queries (torch.sort, then K5's window bounds,
     rmi_sorted_bounds, and K5's scatter entry, at the default size),
     search_sorted of the same queries sorted (rmi_sorted_bounds, then K5)
     and fast_search of them (a packed plan: one rmi_packed_search launch
     and nothing else, asserted, as the two routes' launches are); every
     kernel of the path must have launched in that run, and the keys made
     twice and the two builds must be bit-equal;
  4. the bound |guess - lower_bound| <= err on sampled keys, whose
     lookup must launch K4's fused entry (rmi_lookup_<leaf>) and nothing
     else, an integer top's too (path 5, the zoo); lookup of the random
     queries too, both replayed in phase 7;
  5. exact search against torch.searchsorted: search and search_sorted
     of the path, then search, search_sorted and fast_search on 2^16
     queries (the packed plan); the search rate;
  5b. K5 on that batch (k5_phase): the share of blocks whose window
     exceeds the shared-memory stage, search's device time split into
     the sort, K5's window bounds and K5 with its scatter, the bounds'
     plain version's device time beside its time alone, and K5 at sample
     levels 8 and 16 timed in turns, both checked against
     torch.searchsorted;
  6. the serving curve: lookups/s at 2^14 ... 2^22 queries for the
     bounded path, the packed plan (rmi_packed_search), sort -> K5 ->
     unsort without the density gate, and search_sorted on sorted
     batches, and the packed plan's plain route (the eager torch the
     kernel replaced) beside them, uncounted;
  6b. stages A and B (stage_a_trace): a warm build traced, the device ms
     of its rmi.build.* ranges, then stage A alone and stage B's leaf fit
     alone traced, each device kernel with its calls and device ms and
     the device launches in all (FixDups one rmi_fixdups launch and no
     K1, one each of rmi_key_normalize, rmi_top_cubic_candidates,
     rmi_top_l1_cubic and rmi_top_assign, no torch step of the top fit
     between them; the fit one rmi_aug_fit_moments launch and no K2,
     asserted);
  7. each kernel of the path replayed on the inputs the path gave it,
     against its plain PyTorch version: stage A's normalization (bit-
     equal), the cubic top's candidates (bit-equal), L1 sums (as K6's;
     the chosen row and case bit-equal but on a near tie) and the
     assignment (bit-equal), all on the card, the linear-family and
     normal tops' rmi_top_moments (path 2's trimmed robust_linear span,
     path 8's whole-span linear top on u32 keys and the zoo's normal top,
     200M keys each; bit-equal to the plain version on CPU copies, whose
     sums add in XLA's order) and the
     hint-table tops' rmi_top_table_fit (path 5, the zoo's radix22 and
     f64 rows; bit-equal), each of them the same bits when run again,
     rmi_fixdups (bit-equal) and
     rmi_aug_fit_moments (within select_kernel.fit_tolerance), each also
     the same bits when run again, K1 on the call the build made before
     rmi_fixdups (legacy_calls: FixDups' running max; the data-parallel
     build's K1 calls are its [world]-element carries), the run-length
     pass, K5,
     K5's scatter entry and K4's fused lookup entry on the card (guess and
     err bit-equal; lookup also timed against the two-step route it
     replaced), K3 (the per-leaf maxima, which must be equal) and K4's
     per-element entry on CPU copies (CPU torch.addcmul is an exact FMA),
     the latter also on lookup's own x and leaf ids at 2^22 queries,
     where it is timed;
  8. a build on the card against the plain build on the CPU;
  9. path 2 on the same keys, once path 1's index is freed:
     ``train(data, "robust_linear,cubic", 65536)`` cold and warm (bit-
     equal), its max_err and its index, phases 3-5 for it, then K3 and K4
     for cubic leaves (on CPU copies) and K6 (on the card) replayed
     against their plain versions, and its card-vs-CPU cross-check;
 10. path 3, ``train(data, "cubic,loglinear", 65536)``, the same way,
     its leaf fit one rmi_aug_fit_log_moments launch (no K2 weighted),
     replaying it (within fit_tolerance's log form) on the card and K3
     and K4 for loglinear leaves on CPU copies;
 11. path 4, ``train(data, "cubic,normal", 65536)``, the same way,
     replaying rmi_aug_fit_moments' xx form (timed and logged) and K3
     and K4 for normal leaves;
 11b. path 5, ``train(data, "radix18,linear", 65536)``, a 2^18-entry
     hint-table top over linear leaves, phases 3-6 and 8 for it, its
     lookup one launch of rmi_lookup_linear with the top evaluated in the
     kernel (its table folded into the rows: the route asserted,
     INT_ROUTES), timed beside its bound (the share logged), the two-step
     route (the top in torch, then rmi_leaf_eval_linear), its plain
     version and path 1's fused entry, its packed search and K5's window
     bounds (the hint table read in place) timed beside path 1's,
     its kernels (FixDups, the leaf fit, K3 and K4 linear, the run-length
     pass, the fused lookup, both K5 entries, the packed search and the
     bounds) replayed
     against their plain versions; the kernels line keeps path 1's rows;
 11c. path 6, the compile path through the CLI (rmi_tpu_torch.cli.main,
     in a temporary directory deleted at the end), the launches counted
     from 0: the keys written to an SOSD file; 6a ``cubic,linear
     262144`` (path 1's spec) with --stats-file and --zero-build-time:
     RMI_SIZE 6291488 (SOSD_SYNTH.json's simple_model_wiki row), max_err,
     its leaf and avg_log2 equal to path 1's, the artifact loaded back
     onto the card (load_artifact) and its lookup of the path's queries
     bit-equal to path 1's wherever the loaded top keeps the query's
     leaf, search and search_sorted exact; the native server
     (native/rmi_native.cpp, built on first use) and the generated
     books.cpp compiled with g++ -O3 on 2^16 sampled keys and 2^16
     queries: 0 bound violations, exact search, the guesses that differ
     from the card's counted; 6b ``linear_spline,linear 4194304
     --bounded 8`` on the same file: RMI_SIZE 16 + 24 B + 16 knots,
     |pos - lb| <= 8 on 2^22 sampled keys, search with the original keys
     exact, the native server's positions equal to the card's but for a
     lerp within eps of a line boundary (one line up); each step timed;
     the kernels of 6a's serving and of 6b replayed against their plain
     versions; 6b's lookup (one fused lookup and one rmi_cachefix_interp)
     timed beside the route it replaced (the interpolation's plain
     version), and rmi_cachefix_interp beside its plain version and its
     bound;
 11d. the zoo: the other integer-model rows of FAMILIES_200M.json
     (``radix,linear 1024``, ``bradix,linear 1024``, ``histogram,linear
     4096``, ``radix22,cubic 65536`` and ``cubic,radix8 4096``, the last
     with hint-table leaves, swept and served in plain torch) and two
     scalar tops of it, ``normal,linear 4096`` and ``lognormal,linear
     4096`` (the lognormal top's leaf ids from torch, its lookup the two
     steps), all but the f64 row on a packed plan (packed_wide for radix,
     bradix, histogram, cubic,radix8 and the scalar tops), built once
     each on the same keys, with max_err, avg_log2 and the build time
     logged, 0 bound violations on 2^22 sampled keys, whose lookup must be
     one launch of the fused entry (none for hint-table leaves), 0 search
     mismatches on 2^16 queries, fast_search, search_sorted and sort ->
     K5 of 2^22 queries launching rmi_packed_search alone,
     rmi_sorted_bounds and K5, and rmi_sorted_bounds and K5's scatter
     entry (asserted), the packed search of them timed beside its plain
     version, torch.searchsorted and its bound, the fused lookup of 2^22 sampled keys
     bit-equal to its two steps and timed beside them and beside its
     bound, its route asserted (INT_ROUTES: the histogram's pivots staged
     in a block, radix22's table in place, none for radix and bradix),
     the fused lookup and K6 (for ``radix22,cubic``) replayed, and each
     one's card-vs-CPU cross-check;
 11e. path 7, ``cubic,linear 262144`` on f64 keys: path 1's keys cast to
     f64 and scaled by 2^-32 (exactly; keys in [0, 2^30]), as images with
     a sign fix: phases 3-5 for it (cold and warm builds bit-equal, the
     bound on 2^22 sampled keys, search of 2^22 random queries with -0.0,
     +-inf and NaN through sort -> K5's scatter entry, search_sorted
     through K5, all against torch.searchsorted on the images), the
     packed plan, rmi_lookup_linear with the f64 key kind timed beside
     path 1's, rmi_lookup_<leaf> for all four leaf kernels on the path's
     queries against the plain version; the CLI on the keys written to a
     ``*_f64`` SOSD file (RMI_SIZE 6291488, the card build's metrics,
     ``double`` keys in the header, load_artifact, the native server with
     key_is_float and the compiled C++ on 2^16 keys and 2^16 queries: 0
     bound violations, exact search); its kernels (FixDups, the leaf fit,
     K3 and K4 linear, the run-length pass, rmi_lookup_linear, both K5
     entries)
     replayed; the card-vs-CPU cross-check at n = 2^20; then the zoo's
     f64 row, ``radix18,linear 65536`` on the same keys (an integer top
     on f64 keys: the hier plan), as a zoo row (11d), its lookup the fused
     entry with the f64 key kind (its table folded into the rows), its
     search through rmi_hier_resolve, also of the images just past
     either end of the keys and of the ends, logged (the image past the
     last key, 2^30, routes by a bit no key has: resolve's ``ends``
     answers it);
 11f. path 8, ``linear,linear 100`` on u32 keys (path 1's keys shifted
     right by 30, the books_200M_uint32 shape): phases 3-5 for it through
     the hierarchical plan (asserted; no K5), its search of 2^22 queries
     one fused lookup and one rmi_hier_resolve launch (asserted), timed
     against bounded_search (one fused lookup and one
     rmi_bounded_lower_bound, asserted; beside the route it replaced, the
     bounded search's plain version) and torch.searchsorted on the same
     batch (median of 7 runs, CUDA events, all exact), lookup timed,
     rmi_bounded_lower_bound timed beside its plain version, its bound
     and its library call (its kernels-line row),
     rmi_hier_resolve timed beside its plain version and its library
     call (its kernels-line row), its other kernels replayed, the
     card-vs-CPU cross-check;
 11g. path 9, the optimizer (optimizer_phase), the launches counted from
     0: one path-1 build under torch.cuda.set_sync_debug_mode("warn"),
     its synchronizing calls counted with the shared inputs, without them
     and in its fetch, then its stages under RMI_PROFILE_BUILD=1; 9a
     ``max_size_wiki``: the wiki keys of SOSD_SYNTH.json (seed 7) made on
     the host and written to ``wiki_ts_200M_uint64``, ``--max-size
     50000000`` through the CLI under RMI_OPTIMIZER_PROFILE=fast: RMI_SIZE
     < 50,000,000, the artifact loaded back onto the card with 0 bound
     violations over every key (2^22 a lookup) and 0 search mismatches on
     2^22 queries, the choice logged beside SOSD_SYNTH.json's TPU row,
     each phase's builds, wall time and device ms a build (as the
     optimizer's profiling.phase timed them: CUDA events around each
     dispatch), the CLI's time split, the chosen configuration built
     again on the wiki keys (its metrics the CLI's, where its max error
     lies) and, with the lookups over every key, its kernels replayed
     against their plain versions; 9b ``--optimize`` under the default
     profile on the paths' keys written to an SOSD file, then
     ``--param-grid`` of its front: each artifact's RMI_SIZE and avg_log2
     equal to the front's; 9d ``robust_linear,cubic 134217728``, the disk
     profile's largest point: its build time and peak device memory, then
     built again (bit-equal) with the bound on 2^22 sampled keys, where
     its max error lies, its kernels (FixDups, K6, K3 and K4 cubic, the
     run-length pass, rmi_lookup_cubic) replayed against their plain
     versions, and its card-vs-CPU cross-check at n = 2^20 with as many
     leaves a key (replays and cross-checks uncounted); then 9c, the
     front at n = 2^20 over branching factors 2^6, 2^10 and 2^14 on the
     card and on the CPU: equal (models, B, size) lists, equal max errors
     (log2 within an ulp) and avg_log2 within 1e-7 relative;
 11h. path 10, the data-parallel build and sharded serving
     (rmi_tpu_torch/parallel/, dp_phase), on path 1's keys written once to
     an SOSD file, by ranks started with multihost.run_ranks (spawn) that
     each load the file onto card 0 and take their shard: 10a
     ``dp_train_two_layer`` of ``cubic,linear 262144`` by four gloo ranks
     sharing card 0, cold and three warm builds (the first two bit-equal,
     the warm median logged) and one more with the host time in
     collectives clocked, held to path 1's index with rmi_tpu's dp
     tolerance (leaf errors within 1 on at most B/20 leaves, leaf rows
     within rtol 1e-6 and atol 1e-8 or, on at most B/20 leaves whose
     intercepts cancel, predictions at their keys within DP_PRED_GAP,
     floors at their epsilon probes at most 1 apart, and the dp row
     within DP_PRED_GAP of the leaf's exact least-squares line, or no
     farther from it than path 1's, avg_log2 within 1e-6 relative plus
     what the differing leaves explain), the bound |guess - yfix| <= err
     over every key (each rank its shard), then rank 0's index
     replicated (``replicate_rmi``) and 2^22 queries served by
     ``shard_queries`` (2^20 a rank, below search's density gate at 200M
     keys: the packed plan) and
     ``unshard``, 0 mismatches, timed; a cold and a warm dp build each of
     ``cubic,normal 65536`` and ``cubic,loglinear 65536`` a rank
     (PATH10_XX and PATH10_W: the callers of K2 xx and K2 weighted), the
     warm one timed with its peak device memory; one more build of each
     spec recorded on rank 0, whose calls of the dp build's per-shard
     forms (DP_FORMS: rmi_fixdups_carry and rmi_span_run_max_carry
     bit-equal, rmi_top_l1_partial within sum_tolerance, rmi_aug_fit_sums
     within fit_sums_tolerance), of K1 (the [world] carries), stage A's
     normalization and assignment, K2 on the targets (within
     centered_tolerance), K2 xx and weighted, K3 and K4 are replayed
     against their plain versions (uncounted; the same bits when run
     again); each rank's peak device memory and launches; 10b the same
     builds by one NCCL rank, held to path 1 the same way, its warm builds
     of the three specs and peak memory logged, and DP_TIMED's rows (the
     dp forms and K2's three entries) timed on its calls; 10c
     ``robust_linear,cubic 4096`` at 2^20
     keys by four gloo ranks on the card against four on the CPU (K3
     cubic and K6 per shard), held to the cross-check's tolerances; 10d
     ``replicate_rmi_per_device`` and ``search_sharded`` over [cuda:0,
     cuda:0] in this process on path 1's index (not built again) for
     2^23 queries, 2^22 a copy, past the density gate: each copy's
     ``search`` through the sort and K5's scatter entry (required, and
     counted), 0 mismatches, its rate beside path 1's search of the same
     batch and 10a's.  Four ranks on one card measure the
     sharded algorithm and its gloo collectives, not scaling over cards;
 11i. path 11, the reference's five other SOSD CI configurations
     (PATH11: tests/test_sosd.py's rows with their flags), the launches
     counted from 0, each through the CLI on SOSD_SYNTH.json's own keys
     (synthetic_dataset("wiki" | "osm", n, seed=7) made on the host and
     written once to SOSD files, the wiki one shared with 9a; first and
     last key and duplicates logged): RMI_SIZE equal to SOSD_SYNTH.json's
     row (a shorter run holds a cachefix size to the top's bytes + 24 B +
     16 knots), the artifact loaded back onto the card with 0 bound
     violations over every key (cachefix: |pos - lb| <= 8 and err = 8), 0
     search mismatches on 2^22 queries over the file's key range
     (cachefix: with the original keys), every entry of the build, the
     lookup and the search route launched, the build again (warm), its
     metrics the CLI's; max_err with its leaf, the keys routed there,
     whether it is the final leaf and empty, avg_log2, cold and warm
     build, the host spline's seconds and the peak device memory logged
     beside the TPU row (no gate); a cachefix lookup of 2^22 keys drawn
     at random timed beside the route it replaced and rmi_cachefix_interp
     beside its plain version (``cache_fix_osm``'s is the kernels-line
     row); on ``cache_fix_wiki`` a search batch made only of queries whose
     window misses (after a run of equal keys: the whole array searched)
     timed beside as many keys, logged; the kernels replayed and the
     card against the CPU at 2^20 keys of the same kind and seed
     (cross_check; train_bounded on both sides
     for a cachefix configuration, the knots equal), uncounted;
 12. a ``cubic,lognormal`` build on the card against the CPU build, at
     the paths' keys per leaf and at 64 keys per leaf, its normal-leaf K3
     and K4 calls (on max(ln x, 0), computed outside the kernels)
     replayed against their plain versions;
 13. the nine card probes (rmi_tpu_torch/ops/probe_kernels.py, the
     kernels of tools/probe_torch_kernels.py), each run once on its
     probe's inputs (D at widths 128 and 2048, in its whole-card form,
     the TPU probe's walk spread over the card) with the launches counted
     from 0, its output held equal to its plain version's on the card
     (D's totals also to the TPU probe's sums, on the table of ones and
     the marked one); D's one-block ns per row logged at 1 and 8
     issuing warps; each probe's ms per call (with spreads), device time
     per call (a profiler trace of 200 calls) and host time per call
     logged beside its library call's.  D is timed cold: each call
     walks the next of several views of one table, whose rows the calls
     before did not leave in L2 (probe_kernels.ring_cold_views).
Each row of the kernels line carries the kernel's time on its path's
largest call (a call under 0.1 ms: the median of five runs of at least
5 ms of calls, logged with their spread) beside the plain version's and,
where one PyTorch call
computes the same function, that call's (library_ms), and the least time
the card could take for the call (bound_ms): the bytes its tensors hold,
each input read once and each output written once (K5: the queries, the
answers, and the 32-byte sectors of keys that decide each answer and
each block's binary search over its stripes; the scatter entry adds its
order; the hier resolve: the queries, guesses, errors and answers, the
sectors that decide each answer and the upper levels; the bounded lower
bound likewise without levels; the cachefix interpolation: the queries,
starts, errors and answers and the sectors of each answer's knot pair and
value pair; the packed search: the queries and answers, the top's
operands and the sectors of each query's base and leaf row around q, of keys[::64]
around lb1 (packed_wide) and of the keys around lb; the window bounds:
each block's two anchors, the bounds and the anchors' row sectors; stage
A's kernels: the images, or x and yfix, in, x, the two sums or the leaf
ids out; the cubic candidates: the sectors of x their two binary
searches read; the moments: x and yfix over the fitted span once,
though their two passes read them twice; the table fit: the sectors of
the images and targets beside each slot's first key, and the table), at
3.35 TB/s, or
its operations at the
peak rate of their type, whichever is larger.
After each path the run logs its wall time and the run's total (``wall``
lines).  The last line is the device JSON; the line before it lists the
kernels, one row per C entry point.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import shutil
import subprocess
import tempfile
import textwrap
import time
import traceback
import warnings
from fractions import Fraction

import numpy as np
import torch

import rmi_tpu_torch
from rmi_tpu_torch import (cli, codegen, config, lookup_fast, native, optimizer,
                           serialize)
from rmi_tpu_torch import keys as keymod
from rmi_tpu_torch import data as rdata
from rmi_tpu_torch.keys import KeyType
from rmi_tpu_torch.lookup import (_rmi_lookup, bounded_search, err_iters, lookup, search,
                                  search_route, search_sorted)
from rmi_tpu_torch.models import get_model, radix
from rmi_tpu_torch.models.base import (kernel_input, leaf_predict, model_float_input,
                                       params_equal, params_to, predict_clamped,
                                       predict_top_assignment)
from rmi_tpu_torch.ops import (_build, cachefix_kernel, cubic_l1_kernel, eval_kernel,
                               hier_kernel, packed_kernel, probe_kernels, scan_kernel,
                               select_kernel, sorted_serve_kernel, sweep_kernel, top_kernel)
from rmi_tpu_torch.parallel import sweep
from rmi_tpu_torch.serialize import rmi_size
from rmi_tpu_torch.train import api as train_api
from rmi_tpu_torch.train import two_layer
from rmi_tpu_torch.utils import profiling
from rmi_tpu_torch.utils import segments as seg

K2_RTOL = 1e-9            # summation order
METRIC_RTOL = 1e-7
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 bandwidth
F64_OPS_PER_S = 34e12         # NVIDIA's data sheet, f64 outside the tensor cores
F32_OPS_PER_S = 67e12         # the same data sheet, f32 outside the tensor cores
INT_OPS_PER_S = 33.5e12       # int32 lanes: half the H100 SXM's 67 TFLOP/s of f32 lanes
SECTOR_BYTES = 32             # the least a load moves from device memory
INF_IMAGE = 0x7FF0000000000000  # the image of f64 +inf: its bits

# one row per C entry point: (entry, module, wrapper name, plain version
# name, device the plain version is compared on (None: the card), source,
# TPU kernel replaced); first the kernels of the build and serving paths
PATH_KERNELS = [
    ("rmi_scan_i32", scan_kernel, "scan_i32", "scan_i32_plain", None,
     "rmi_tpu_torch/csrc/scan.cu", "rmi_tpu/ops/scan_kernel.py:35"),
    # FixDups whole: K1's scan with the arange, compare and select before it
    ("rmi_fixdups", scan_kernel, "fixdups", "fixdups_plain", None,
     "rmi_tpu_torch/csrc/scan.cu", "rmi_tpu/ops/scan_kernel.py:35"),
    # FixDups of a rank's shard in the data-parallel build, with its carry
    ("rmi_fixdups_carry", scan_kernel, "fixdups_carry", "fixdups_carry_plain", None,
     "rmi_tpu_torch/csrc/scan.cu", "rmi_tpu/ops/scan_kernel.py:35"),
    ("rmi_aug_moments", select_kernel, "aug_centered_moments",
     "aug_centered_moments_plain", None,
     "rmi_tpu_torch/csrc/moments.cu", "rmi_tpu/ops/select_kernel.py:100"),
    ("rmi_aug_moments_weighted", select_kernel, "aug_centered_moments",
     "aug_centered_moments_plain", None,
     "rmi_tpu_torch/csrc/moments.cu", "rmi_tpu/ops/select_kernel.py:100"),
    ("rmi_aug_moments_xx", select_kernel, "aug_centered_xx", "aug_centered_xx_plain",
     None,
     "rmi_tpu_torch/csrc/moments.cu", "rmi_tpu/ops/select_kernel.py:100"),
    # the linear and normal leaf fits whole: K2's step with the range sums
    # and means before it
    ("rmi_aug_fit_moments", select_kernel, "aug_fit_moments", "aug_fit_moments_plain", None,
     "rmi_tpu_torch/csrc/moments.cu", "rmi_tpu/ops/select_kernel.py:100"),
    # the loglinear leaf fit whole: K2 has_w with ln y, its weights and the
    # masked range sums before it
    ("rmi_aug_fit_log_moments", select_kernel, "aug_fit_log_moments",
     "aug_fit_log_moments_plain", None, "rmi_tpu_torch/csrc/moments.cu",
     "rmi_tpu/ops/select_kernel.py:100"),
    # the fits' first pass alone: the dp build's per-clip sums, which cross
    # ranks before K2 takes the centered moments about their means
    ("rmi_aug_fit_sums", select_kernel, "aug_fit_sums", "aug_fit_sums_plain", None,
     "rmi_tpu_torch/csrc/moments.cu", "rmi_tpu/ops/select_kernel.py:100"),
    ("rmi_sweep_max_linear", sweep_kernel, "sweep_leaf_max", "sweep_leaf_max_plain",
     "cpu", "rmi_tpu_torch/csrc/sweep.cu", "rmi_tpu/ops/sweep_kernel.py:131"),
    ("rmi_sweep_max_cubic", sweep_kernel, "sweep_leaf_max", "sweep_leaf_max_plain",
     "cpu", "rmi_tpu_torch/csrc/sweep.cu", "rmi_tpu/ops/sweep_kernel.py:131"),
    ("rmi_sweep_max_loglinear", sweep_kernel, "sweep_leaf_max", "sweep_leaf_max_plain",
     "cpu", "rmi_tpu_torch/csrc/sweep.cu", "rmi_tpu/ops/sweep_kernel.py:131"),
    ("rmi_sweep_max_normal", sweep_kernel, "sweep_leaf_max", "sweep_leaf_max_plain",
     "cpu", "rmi_tpu_torch/csrc/sweep.cu", "rmi_tpu/ops/sweep_kernel.py:131"),
    # the reverse running min of _run_lengths_i32 and the max over it
    ("rmi_span_run_max", sweep_kernel, "span_run_max", "span_run_max_plain", None,
     "rmi_tpu_torch/csrc/run_max.cu", "rmi_tpu/ops/scan_kernel.py:35"),
    # the same over a rank's clips in the data-parallel build, the runs that
    # cross its edges carried
    ("rmi_span_run_max_carry", sweep_kernel, "span_run_max_carry",
     "span_run_max_carry_plain", None, "rmi_tpu_torch/csrc/run_max.cu",
     "rmi_tpu/ops/scan_kernel.py:35"),
    ("rmi_leaf_eval_linear", eval_kernel, "leaf_eval_clamped",
     "leaf_eval_clamped_plain", "cpu",
     "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39"),
    ("rmi_leaf_eval_cubic", eval_kernel, "leaf_eval_clamped",
     "leaf_eval_clamped_plain", "cpu",
     "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39"),
    ("rmi_leaf_eval_loglinear", eval_kernel, "leaf_eval_clamped",
     "leaf_eval_clamped_plain", "cpu",
     "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39"),
    ("rmi_leaf_eval_normal", eval_kernel, "leaf_eval_clamped",
     "leaf_eval_clamped_plain", "cpu",
     "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39"),
    # lookup whole in one launch, held to its plain route on the card
    *[(f"rmi_lookup_{k}", eval_kernel, "lookup_clamped", "lookup_clamped_plain", None,
       "rmi_tpu_torch/csrc/eval.cu", "rmi_tpu/ops/eval_kernel.py:39")
      for k in eval_kernel.LEAF_KERNELS],
    ("rmi_serve_sorted", sorted_serve_kernel, "serve_sorted", "serve_sorted_plain",
     None, "rmi_tpu_torch/csrc/sorted_serve.cu",
     "rmi_tpu/ops/sorted_serve_kernel.py:88"),
    ("rmi_serve_sorted_scatter", sorted_serve_kernel, "serve_sorted_scatter",
     "serve_sorted_scatter_plain", None, "rmi_tpu_torch/csrc/sorted_serve.cu",
     "rmi_tpu/ops/sorted_serve_kernel.py:88"),
    ("rmi_cubic_l1", cubic_l1_kernel, "cubic_l1_sums", "cubic_l1_sums_plain", None,
     "rmi_tpu_torch/csrc/cubic_l1.cu", "rmi_tpu/ops/select_kernel.py:30"),
    # the hier plan's resolve: rmi_tpu runs it in XLA beside K4
    # (_fast_search_df64), no Pallas call of its own; lookup_fast calls the
    # wrapper by its module's name
    ("rmi_hier_resolve", lookup_fast, "resolve", "resolve_plain", None,
     "rmi_tpu_torch/csrc/hier.cu", "rmi_tpu/lookup_fast.py:396"),
    # the cachefix serving path: rmi_tpu runs both in XLA beside K4
    # (_bounded_search_jit, _cachefix_interp), no Pallas call of their own
    ("rmi_bounded_lower_bound", cachefix_kernel, "bounded_lower_bound",
     "bounded_lower_bound_plain", None, "rmi_tpu_torch/csrc/cachefix.cu",
     "rmi_tpu/lookup.py:92"),
    ("rmi_cachefix_interp", cachefix_kernel, "cachefix_interp", "cachefix_interp_plain", None,
     "rmi_tpu_torch/csrc/cachefix.cu", "rmi_tpu/lookup.py:97"),
    # the packed plan's search and K5's window bounds: rmi_tpu runs both in
    # XLA (_fast_search_packed and _wide, _sorted_stats_direct), no Pallas
    # call of their own
    ("rmi_packed_search", packed_kernel, "packed_search", "packed_search_plain", None,
     "rmi_tpu_torch/csrc/packed.cu", "rmi_tpu/lookup_fast.py:420"),
    ("rmi_sorted_bounds", packed_kernel, "sorted_bounds", "sorted_bounds_plain", None,
     "rmi_tpu_torch/csrc/packed.cu", "rmi_tpu/lookup_fast.py:683"),
    # stage A of the build after FixDups: rmi_tpu computes it in one XLA
    # program (_assign_body), no Pallas call of its own (the card tests hold
    # the assignment to its plain version on the CPU too, where
    # torch.addcmul is an exact FMA)
    ("rmi_key_normalize", top_kernel, "key_normalize", "key_normalize_plain", None,
     "rmi_tpu_torch/csrc/top.cu", "rmi_tpu/train/two_layer.py:176"),
    # the cubic top's fit: its candidates (rmi_tpu's _fit_cubic_ranges over
    # the top's one span), then the L1 sums and the choice
    ("rmi_top_cubic_candidates", top_kernel, "top_cubic_candidates",
     "top_cubic_candidates_plain", None, "rmi_tpu_torch/csrc/top.cu",
     "rmi_tpu/models/cubic.py:63"),
    ("rmi_top_l1_cubic", top_kernel, "top_l1_cubic", "top_l1_cubic_plain", None,
     "rmi_tpu_torch/csrc/top.cu", "rmi_tpu/train/two_layer.py:176"),
    # its partial sums over a rank's shard in the data-parallel build
    # (rmi_tpu's _dist_fit_cubic_top, in its shard_map program)
    ("rmi_top_l1_partial", top_kernel, "top_l1_partial", "top_l1_partial_plain", None,
     "rmi_tpu_torch/csrc/top.cu", "rmi_tpu/parallel/dp_trainer.py:275"),
    # the linear-family and normal tops' fits (rmi_tpu's _linear_fit_top,
    # _robust_fit_top, _normal_fit_top): held to the plain version on the
    # CPU, whose whole-array sums add in XLA's order, as the kernel's do
    ("rmi_top_moments", top_kernel, "top_moments", "top_moments_plain", "cpu",
     "rmi_tpu_torch/csrc/top_fit.cu", "rmi_tpu/models/linear.py:164"),
    # the hint-table tops' fit (rmi_tpu's _make_radix_table_fit)
    ("rmi_top_table_fit", top_kernel, "top_table_fit", "top_table_fit_plain", None,
     "rmi_tpu_torch/csrc/top_fit.cu", "rmi_tpu/models/radix.py:186"),
    ("rmi_top_assign", top_kernel, "top_assign", "top_assign_plain", None,
     "rmi_tpu_torch/csrc/top.cu", "rmi_tpu/train/two_layer.py:176"),
]
# then the card probes, driven by their own phase
PROBE_KERNELS = [
    (p.entry, probe_kernels, p.wrapper.__name__, p.plain.__name__, None,
     "rmi_tpu_torch/csrc/probes.cu", p.replaces) for p in probe_kernels.PROBES]
KERNELS = PATH_KERNELS + PROBE_KERNELS
# (spec, B, the C entry points the path launches, those it replays)
# search launches K5's scatter entry, search_sorted K5 itself, each after
# K5's window bounds; fast_search of a packed plan the packed search
K5 = ("rmi_serve_sorted", "rmi_serve_sorted_scatter")
PACKED = ("rmi_packed_search", "rmi_sorted_bounds")
RUN_MAX = "rmi_span_run_max"
# stage A: every path's build takes FixDups in one kernel, normalizes its
# keys and assigns them to leaves in a kernel; the cubic, linear-family,
# normal and hint-table tops fit in kernels too.  Linear and normal leaves
# fit in one kernel (stage B), loglinear leaves in another (PATH3).
FIT = ("rmi_fixdups", "rmi_aug_fit_moments")
# K1, which the build's FixDups launched before rmi_fixdups, and which the
# data-parallel build (path 10) launches on the [world] carries alone, is
# timed on path 1's FixDups input (legacy_calls); K2, whose callers are the
# data-parallel build's leaf moments, on path 10b's
NORM_ASSIGN = ("rmi_key_normalize", "rmi_top_assign")
# a cubic top's stage A: the normalization, its fit in two entries, the
# assignment; a linear-family or normal top fits in rmi_top_moments, a
# hint-table top in rmi_top_table_fit
STAGE_A = ("rmi_key_normalize", "rmi_top_cubic_candidates", "rmi_top_l1_cubic",
           "rmi_top_assign")
MOMENTS = "rmi_top_moments"
TABLE_FIT = "rmi_top_table_fit"
# K4: the build's epsilon probes launch the per-element entry, lookup the fused one
PATH1 = ("cubic,linear", 262144,
         ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", *K5, *PACKED, *STAGE_A),
         ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", *K5, *PACKED, *STAGE_A,
          "rmi_scan_i32"))
PATH2 = ("robust_linear,cubic", 65536,
         ("rmi_fixdups", "rmi_sweep_max_cubic", RUN_MAX, "rmi_leaf_eval_cubic",
          "rmi_lookup_cubic", *K5, "rmi_cubic_l1", *PACKED, *NORM_ASSIGN, MOMENTS),
         ("rmi_sweep_max_cubic", RUN_MAX, "rmi_leaf_eval_cubic", "rmi_lookup_cubic",
          "rmi_cubic_l1", MOMENTS))
# loglinear leaves fit in one kernel (K2 weighted, which the build launched
# before it, serves the data-parallel build: path 10)
PATH3 = ("cubic,loglinear", 65536,
         ("rmi_fixdups", "rmi_aug_fit_log_moments", "rmi_sweep_max_loglinear", RUN_MAX,
          "rmi_leaf_eval_loglinear", "rmi_lookup_loglinear", *K5, *PACKED, *STAGE_A),
         ("rmi_aug_fit_log_moments", "rmi_sweep_max_loglinear", RUN_MAX,
          "rmi_leaf_eval_loglinear", "rmi_lookup_loglinear"))
PATH4 = ("cubic,normal", 65536,
         ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_normal", RUN_MAX,
          "rmi_leaf_eval_normal", "rmi_lookup_normal", *K5, *PACKED, *STAGE_A),
         ("rmi_sweep_max_normal", RUN_MAX, "rmi_leaf_eval_normal", "rmi_lookup_normal"))
# an integer (hint-table) top over linear leaves: lookup is one launch of
# the fused entry, its top evaluated in the kernel (csrc/int_top.cuh); the
# build normalizes the keys for the leaves and assigns them under the
# hint table
PATH5 = ("radix18,linear", 65536,
         ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", *K5, *PACKED, *NORM_ASSIGN, TABLE_FIT),
         ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", *K5, *PACKED, *NORM_ASSIGN))
# path 7: path 1's spec on f64 keys (FAMILIES_200M.json's
# cubic,linear_f64_262144 row); the fused lookup decodes f64 images
PATH7 = ("cubic,linear", 262144,
         ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", *K5, *PACKED, *STAGE_A),
         ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", *K5, *PACKED, *STAGE_A))
# path 8: the reference's books-u32 CI config (FAMILIES_200M.json's
# linear,linear_u32_100 row), whose ~2M-key leaves no packed plan covers:
# the hierarchical plan, which never reaches K5: one fused lookup and one
# rmi_hier_resolve a batch
PATH8 = ("linear,linear", 100,
         ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", "rmi_hier_resolve", *NORM_ASSIGN,
          MOMENTS),
         ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
          "rmi_leaf_eval_linear", "rmi_lookup_linear", "rmi_hier_resolve", *NORM_ASSIGN,
          MOMENTS))
HIER_RUNS = 7             # timed runs of path 8's hier and bounded searches
# the route of each integer top's lookup in paths 5 and 7 and the zoo
# (eval_kernel.route_name): where its operand lies when it is read
INT_ROUTES = {"radix18": "folded", "histogram": "block", "radix22": "l2", "radix": "none",
              "bradix": "none"}
# the other integer-model rows of FAMILIES_200M.json and two of its scalar
# tops, and the entries each replays: an integer top's lookup is the fused
# entry; hint-table leaves keep their torch step and launch none; a
# lognormal top keeps its torch top before K4's per-element entry, and in
# the packed search before rmi_packed_search; every row but the f64 one
# serves a packed plan (radix, bradix, histogram, cubic,radix8, normal and
# lognormal a packed_wide one); the radix22, cubic and normal tops' fits
# are kernels too
ZOO = [("radix,linear", 1024, ("rmi_lookup_linear", *PACKED)),
       ("bradix,linear", 1024, ("rmi_lookup_linear", *PACKED)),
       ("histogram,linear", 4096, ("rmi_lookup_linear", *PACKED)),
       ("radix22,cubic", 65536, ("rmi_cubic_l1", "rmi_lookup_cubic", *PACKED, TABLE_FIT)),
       ("cubic,radix8", 4096, (*PACKED, "rmi_top_cubic_candidates")),
       ("normal,linear", 4096, ("rmi_lookup_linear", *PACKED, MOMENTS)),
       ("lognormal,linear", 4096, ("rmi_leaf_eval_linear", *PACKED))]
# the zoo row on path 7's f64 keys: an integer top on f64 keys takes the
# hier plan, so it drives the fused lookup and rmi_hier_resolve with the
# f64 key kind; its hint table is fitted on the keys' integer images
ZOO_F64 = ("radix18,linear", 65536, ("rmi_lookup_linear", "rmi_hier_resolve", TABLE_FIT))
# the lognormal cross-check's build, and the entries replayed from it
LOGNORMAL = ("cubic,lognormal", 65536, (),
             ("rmi_aug_fit_moments", "rmi_sweep_max_normal", RUN_MAX, "rmi_leaf_eval_normal"))
CURVE = [1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22]   # serving curve batch sizes
SEARCH_TRACED = 5         # search batches the K5 phase traces


def log(*a):
    print(*a, flush=True)


class Recorder:
    """Keeps the arguments of every call of the kernel wrappers while
    installed, so each kernel can be replayed on a path's inputs."""

    def __init__(self):
        self.wrappers = {(mod, name) for _, mod, name, *_ in PATH_KERNELS}
        self.calls = {name: [] for _, name in self.wrappers}
        self._saved = []

    def __enter__(self):
        self._saved = []
        for mod, name in self.wrappers:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def rec(*args, _fn=fn, _name=name, **kw):
                self.calls[_name].append((args, kw))
                return _fn(*args, **kw)
            setattr(mod, name, rec)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def calls_of(self, entry, name):
        """The recorded calls of wrapper ``name`` that launch ``entry``:
        K2 launches one entry point per variant, K3 and K4 one per leaf
        kernel."""
        return [(a, kw) for a, kw in self.calls[name]
                if entry_of(name, kw) in (None, entry)]


def entry_of(name, kw):
    """The C entry point a call of wrapper ``name`` with keywords ``kw``
    launches, where the wrapper has more than one."""
    if name == "aug_centered_moments":
        weighted = kw.get("weights") is not None or kw.get("log")
        return "rmi_aug_moments_weighted" if weighted else "rmi_aug_moments"
    if name == "lookup_clamped":       # a lognormal or integer model: the two-step route
        kernel = get_model(kw["leaf_type"]).leaf_kernel
        if kernel is None:             # hint-table leaves: plain torch, no launch
            return ""
        return (f"rmi_lookup_{kernel}" if eval_kernel.fused_lookup(kw["top_type"],
                                                                    kw["leaf_type"])
                else f"rmi_leaf_eval_{kernel}")
    if "leaf_type" in kw:
        prefix = {"sweep_leaf_max": "rmi_sweep_max_",
                  "leaf_eval_clamped": "rmi_leaf_eval_"}
        return prefix[name] + get_model(kw["leaf_type"]).leaf_kernel
    return None


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


SHORT_MS = 0.1            # calls shorter than this are timed in runs of RUN_MS
RUN_MS = 5.0
RUNS = 5


def row_ms(fn, iters):
    """(ms per call, (least, most)): over ``iters`` calls, or for a call
    under SHORT_MS the median of RUNS runs of at least RUN_MS of calls
    each, with the runs' spread."""
    ms = cuda_ms(fn, iters)
    if ms >= SHORT_MS:
        return ms, (ms, ms)
    reps = max(iters, math.ceil(RUN_MS / max(ms, 1e-4)))
    runs = sorted(cuda_ms(fn, reps) for _ in range(RUNS))
    return runs[RUNS // 2], (runs[0], runs[-1])


def spread(t):
    return f"{t[0]:.4f} ms ({t[1][0]:.4f}-{t[1][1]:.4f})"


def plain_args(name, args, kw, where):
    """Arguments of the plain version on ``where`` (None: where they
    are); K1's plain version takes no fill, lookup's none of the kernel's
    lookup table or top operands, the resolve's none of the packed
    levels, the interpolation's none of the knots' sample."""
    def move(a):
        if isinstance(a, dict):              # an integer top's parameters
            return {k: move(v) for k, v in a.items()}
        return a.to(where or a.device) if torch.is_tensor(a) else a
    args = [move(a) for a in args]
    kw = {k: move(v) for k, v in kw.items()
          if (name, k) not in (("scan_i32", "fill"), ("lookup_clamped", "table"),
                               ("lookup_clamped", "top_args"), ("resolve", "packed"),
                               ("cachefix_interp", "sample"))}
    return args, kw


def first_tensor(args):
    """A wrapper call's first tensor argument (the resolve's first
    argument is its list of levels, its queries the next)."""
    return next(a for a in args if torch.is_tensor(a))


# the argument that holds a wrapper's queries where its first tensor does
# not (the keys, knots or the top's row come first)
QUERY_ARG = {"bounded_lower_bound": 1, "cachefix_interp": 2, "top_assign": 2}


def call_size(args, name=None):
    """The rows of a wrapper call: its queries', or its first tensor's."""
    return (args[QUERY_ARG[name]] if name in QUERY_ARG else first_tensor(args)).shape[0]


def compare(name, got, want, args, kw):
    """(max abs error, ok) of a kernel output against its plain version."""
    if name == "aug_centered_moments" and args[1].dtype == torch.int32:
        # the dp build's call on the FixDups targets, given the means: the
        # two sides differ by summation alone (select_kernel.centered_tolerance)
        x, y, mean_x, mean_y, lo, hi = [a.cpu() for a in args]
        tol = select_kernel.centered_tolerance(x, y, mean_x, mean_y, lo, hi,
                                               [t.cpu() for t in want], log=kw.get("log", False))
        diffs = [(g.cpu() - w.cpu()).abs() for g, w in zip(got, want)]
        return (max(float(d.max()) if d.numel() else 0.0 for d in diffs),
                all(bool((d <= t).all()) for d, t in zip(diffs, tol)))
    if name == "aug_centered_moments":
        x, y, mean_x, mean_y, lo, hi = [a.cpu() for a in args]
        w = kw.get("weights")
        (m2, c), (wm2, wc) = [[t.cpu() for t in r] for r in (got, want)]
        syy = select_kernel.aug_centered_moments_plain(
            y, y, mean_y, mean_y, lo, hi, weights=None if w is None else w.cpu())[0]
        tol_m2 = K2_RTOL * wm2.abs()
        tol_c = K2_RTOL * wc.abs() + 1e-12 * torch.sqrt(wm2.clamp(min=0) * syy)
        err = max(float((m2 - wm2).abs().max()), float((c - wc).abs().max()))
        ok = bool(((m2 - wm2).abs() <= tol_m2).all() and ((c - wc).abs() <= tol_c).all())
        return err, ok
    if name in ("aug_fit_moments", "aug_fit_log_moments"):
        # fit_tolerance: the plain sums are prefix-sum differences, each within
        # 2^11 L u P of the exact sum (at 200M keys P is ~1e8 for x and ~2e16
        # for the targets, ulp 4), the kernel's within cnt u of the leaf's (its
        # sum of y exact; the log form's count exact, its sum of ln y within
        # (cnt + 2) u, an ulp of each ln y allowed); the means over cnt, the
        # centered sums by cnt dm^2 about the two means and each side's
        # summation (cnt u)
        x, y, lo, hi = args
        tol = select_kernel.fit_tolerance(x, y, lo, hi, want,
                                          log_form=name == "aug_fit_log_moments")
        diffs = [(g - w).abs() for g, w in zip(got, want)]
        return (max(float(d.max()) if d.numel() else 0.0 for d in diffs),
                all(bool((d <= t).all()) for d, t in zip(diffs, tol)))
    if name == "aug_fit_sums":
        # fit_sums_tolerance: the counts exact, the plain prefix-sum
        # differences within 2^11 L u P, the kernel's sums within cnt u S (its
        # sum of y exact; ln y an ulp a key)
        x, y, lo, hi = [None if a is None else a.cpu() for a in args]
        tol = select_kernel.fit_sums_tolerance(x, y, lo, hi, [t.cpu() for t in want],
                                               log=kw.get("log", False))
        diffs = [(g.cpu() - w.cpu()).abs() for g, w in zip(got, want)]
        return (max(float(d.max()) if d.numel() else 0.0 for d in diffs),
                all(bool((d <= t).all()) for d, t in zip(diffs, tol)))
    if name == "top_l1_partial":     # the shard's two sums, as K6's
        return compare_l1(got.split(1), want.split(1), "rmi_top_l1_partial")
    if name == "aug_centered_xx":
        m2, wm2 = got.cpu(), want.cpu()
        return (float((m2 - wm2).abs().max()),
                bool(((m2 - wm2).abs() <= K2_RTOL * wm2.abs()).all()))
    if name == "cubic_l1_sums":
        return compare_l1(got, want, "K6")
    if name == "top_l1_cubic":
        # the sums as K6's; the chosen row and its case bit-equal unless the
        # two sums are a near tie
        err, ok = compare_l1(got[0].split(1), want[0].split(1), "rmi_top_l1_cubic")
        c, l = want[0].cpu().tolist()
        tie = abs(l - c) <= float(cubic_l1_kernel.sum_tolerance(want[0][:1].cpu())
                                  + cubic_l1_kernel.sum_tolerance(want[0][1:].cpu()))
        return err, ok and (tie or (same_bits(got[1].cpu(), want[1].cpu())
                                    and torch.equal(got[2].cpu(), want[2].cpu())))
    if name in ("top_cubic_candidates", "top_moments"):    # f64 bits, NaN as NaN
        g, w = got.cpu(), want.cpu()
        nan = w.isnan()
        ok = torch.equal(g.isnan(), nan) and same_bits(g[~nan], w[~nan])
        return float((g[~nan] - w[~nan]).abs().max()) if (~nan).any() else 0.0, ok
    if name == "top_table_fit":          # the table and (prefix, bits) equal
        diffs = [compare(None, got[k], want[k], args, kw) for k in ("table", "w_int")]
        return max(d[0] for d in diffs), all(d[1] for d in diffs)
    if name == "key_normalize":             # f64 bits, every NaN a NaN (where they lie)
        nan = want.isnan()
        ok = torch.equal(got.isnan(), nan) and torch.equal(got[~nan].view(torch.int64),
                                                           want[~nan].view(torch.int64))
        return float((got[~nan] - want[~nan]).abs().max()) if want.numel() else 0.0, ok
    if name in ("lookup_clamped", "sorted_bounds"):    # (guess, err), (lo, hi): bit-equal
        diffs = [compare(None, g, w, args, kw) for g, w in zip(got, want)]
        return max(d[0] for d in diffs), all(d[1] for d in diffs)
    got, want = got.cpu().long(), want.cpu().long()
    err = int((got - want).abs().max()) if got.numel() else 0
    return err, bool(torch.equal(got, want))


def compare_l1(got, want, label):
    """K6 and the cubic top's sums: both sums within
    cubic_l1_kernel.sum_tolerance, and the choice l_err < c_err the same
    wherever the two sums are not a near tie, that is closer than their
    two tolerances."""
    (c, l), (wc, wl) = [[t.cpu() for t in r] for r in (got, want)]
    tc, tl = cubic_l1_kernel.sum_tolerance(wc), cubic_l1_kernel.sum_tolerance(wl)
    err = max(float((c - wc).abs().max()), float((l - wl).abs().max()))
    near_tie = (wl - wc).abs() <= tc + tl
    same_choice = ((l < c) == (wl < wc)) | near_tie
    log(f"  {label}: {int(near_tie.sum())} near-tie leaves of {c.shape[0]}, "
        f"{int(((l < c) != (wl < wc)).sum())} choices differ")
    return err, bool(((c - wc).abs() <= tc).all() and ((l - wl).abs() <= tl).all()
                     and same_choice.all())


def check_kernels(rec, launches, entries, timed=True):
    """Replay each of ``entries`` on its recorded calls against its plain
    version, and time its largest call (K4's per-element entries: on
    lookup's own inputs) beside the plain version; without ``timed``
    only replay, each row holding its max abs error."""
    rows = {}
    for entry, mod, name, plain_name, where, source, replaces in PATH_KERNELS:
        if entry not in entries:
            continue
        wrapper, plain = getattr(mod, name), getattr(mod, plain_name)
        calls = rec.calls_of(entry, name)
        if not calls:
            raise RuntimeError(f"{entry}: no call recorded on the path")
        worst = 0
        for args, kw in calls:
            worst = max(worst, replay(entry, name, wrapper, plain, where, args, kw))
        # time the largest call: kernel, plain version and library call
        # on the card, and its bound
        args, kw = max(calls, key=lambda c: call_size(c[0], name))
        if name == "leaf_eval_clamped":
            lookups = [c for c in rec.calls["lookup_clamped"]
                       if get_model(c[1]["leaf_type"]).leaf_kernel
                       == get_model(kw["leaf_type"]).leaf_kernel]
            if lookups and not timed:
                args, kw = lookup_leaf_call(*max(lookups, key=lambda c: call_size(c[0])))
                worst = max(worst, replay(entry, name, wrapper, plain, where, args, kw))
            elif lookups:
                out = wrapper(*args, **kw)
                log(f"kernel {entry} at {list(args[0].shape)} (the build's epsilon "
                    f"probes): {spread(row_ms(lambda: wrapper(*args, **kw), 10))}")
                del out
                args, kw = lookup_leaf_call(*max(lookups, key=lambda c: call_size(c[0])))
                worst = max(worst, replay(entry, name, wrapper, plain, where, args, kw))
        if not timed:
            rows[entry] = {"max_abs_err": worst}
            log(f"kernel {entry}: {len(calls)} calls on the path match the plain "
                f"version (max abs err {worst})")
            continue
        pa, pk = plain_args(name, args, kw, first_tensor(args).device)
        out = wrapper(*args, **kw)
        ms = row_ms(lambda: wrapper(*args, **kw), 10)
        plain_ms = row_ms(lambda: plain(*pa, **pk), 3)
        lib = library_call(name, args, kw)
        library_ms = None if lib is None else row_ms(lib, 10)
        bound_ms, bound_by, nbytes, ops = bound_of(name, args, kw, out)
        del out
        rows[entry] = {"name": entry, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": launches[entry],
                       "max_abs_err": worst, "ms": ms[0], "plain_ms": plain_ms[0],
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": None if library_ms is None else library_ms[0]}
        log(f"kernel {entry}: {len(calls)} calls on the path match the plain "
            f"version (max abs err {worst}); {spread(ms)} vs plain {spread(plain_ms)}, "
            f"library {library_ms and spread(library_ms)}, bound {bound_ms:.4f} ms "
            f"({bound_by}: {nbytes / 1e9:.4f} GB, {ops:.4g} ops) at {call_size(args, name)}")
        if name == "lookup_clamped":
            def two_steps():
                return eval_kernel.lookup_steps(
                    *args, kw["top_type"], kw["leaf_type"], eval_kernel.leaf_eval_clamped,
                    kw.get("key_type", KeyType.U64))
            same_as_steps(entry, wrapper(*args, **kw), two_steps())
            steps = row_ms(two_steps, 10)
            log(f"lookup {kw['top_type']},{kw['leaf_type']} at {call_size(args)}: "
                f"fused {spread(ms)}, two steps (torch top eval, then "
                f"rmi_leaf_eval_*: the route before the fused entry) {spread(steps)}, "
                f"plain {spread(plain_ms)}; bound {bound_ms:.4f} ms")
            if get_model(kw["top_type"]).output_int:
                int_lookup_line(f"{kw['top_type']},{kw['leaf_type']}", ms, bound_ms,
                                plain_ms, kw)
    return rows


def bound_of(name, args, kw, out):
    """(bound ms, "bytes" or "operations", bytes, operations) of one
    wrapper call: the larger of work()'s bytes over HBM_BYTES_PER_S and
    its operations over their peak rate."""
    nbytes, ops, peak = work(name, args, kw, out)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes, ops


def int_lookup_line(spec, ms, bound_ms, plain_ms, kw):
    """Log an integer top's fused lookup (its time, bound and share of
    the bound, its plain version's time, the route its operand took:
    eval_kernel.route_name of the route lookup passed) and hold the route
    to INT_ROUTES."""
    top = kw["top_type"]
    route = eval_kernel.route_name(top, kw["top_args"][5])
    log(f"lookup {spec}: {spread(ms)}, bound {bound_ms:.4f} ms, share "
        f"{bound_ms / ms[0]:.3f}, plain {spread(plain_ms)}, route {route}")
    if route != INT_ROUTES[top]:
        raise RuntimeError(f"{spec}: the lookup took the {route} route, not "
                           f"{INT_ROUTES[top]}")


def same_as_steps(entry, fused, steps):
    """The fused lookup's (guess, err) against its two steps' on the card
    (the top in torch, the leaf in rmi_leaf_eval_*), bit for bit."""
    if not (torch.equal(fused[0], steps[0]) and torch.equal(fused[1], steps[1])):
        raise RuntimeError(f"{entry}: the fused lookup disagrees with its two steps")


# wrappers whose kernels are also run twice in a replay, the same bits
# each time (their sums' order fixed, no float atomics)
RERUN = ("fixdups", "aug_fit_moments", "aug_fit_log_moments", "top_cubic_candidates",
         "top_l1_cubic", "top_moments", "top_table_fit", "fixdups_carry", "aug_fit_sums",
         "top_l1_partial", "span_run_max_carry", "aug_centered_moments")


def same_bits(a, b):
    """Two outputs (a tensor, a tuple or a dict of them) equal bit for bit."""
    if isinstance(a, dict):
        a, b = tuple(a.values()), tuple(b[k] for k in a)
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch.equal(x.view(torch.int64) if x.is_floating_point() else x,
                           y.view(torch.int64) if y.is_floating_point() else y)
               for x, y in zip(a, b))


def replay(entry, name, wrapper, plain, where, args, kw):
    """A wrapper call against its plain version; its max abs error."""
    got = wrapper(*args, **kw)
    if name in RERUN and not same_bits(got, wrapper(*args, **kw)):
        raise RuntimeError(f"{entry}: two runs gave different bits")
    pa, pk = plain_args(name, args, kw, where)
    want = plain(*pa, **pk)
    err, ok = compare(name, got, want, args, kw)
    if not ok:
        raise RuntimeError(f"{entry}: kernel disagrees with its plain version "
                           f"(max abs err {err})")
    return err


def lookup_leaf_call(args, kw):
    """The per-element K4 call a lookup's leaf step makes: lookup's kernel
    input and leaf ids, bound n - 1 (eval_kernel.lookup_steps)."""
    queries, top_w, leaf_w, leaf_errors, n, kminf, s = args
    mtop, mleaf = get_model(kw["top_type"]), get_model(kw["leaf_type"])
    kt = kw.get("key_type", KeyType.U64)
    x = kernel_input(mleaf, model_float_input(mleaf, queries, kminf, s, kt))
    ids = predict_top_assignment(mtop, top_w,
                                 model_float_input(mtop, queries, kminf, s, kt),
                                 leaf_errors.shape[0] - 1)
    return (x, leaf_w, ids, n - 1), {"leaf_type": kw["leaf_type"]}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


# f64 operations per element of each leaf kernel (a division counted as one)
LEAF_OPS = {"linear": 2, "cubic": 6, "loglinear": 10, "normal": 14}
# f64 operations of CUDA's log() of a double in rmi_aug_fit_log_moments' SASS
# (tools/time_torch_fit.py --sass: ~32 f64 instructions a key in its chunks'
# sums, 16 of them DFMA, each counted two: PERF.md §6)
LOG_F64_OPS = 48
# integer operations of radix, bradix or a hint table's bucket, per key
INT_TOP_OPS = 10


def top_work(top_type, top_w):
    """(bytes, operations a query) of a top: an affine top's row and its
    leaf kernel's operations; an integer top's parameters, table or pivots
    at their model size, and its shifts and compares (a histogram's
    halving steps)."""
    kind = eval_kernel.TOP_KINDS[eval_kernel.top_kind(top_type)]
    if kind in LEAF_OPS:
        return _nbytes(top_w), LEAF_OPS[kind]
    top_bytes = sum(_nbytes(top_w[k]) for k in ("w_int", "high", "table", "pivots")
                    if k in top_w)
    return top_bytes, (3 * max(1, top_w["pivots"].shape[0]).bit_length()
                       if kind == "histogram" else INT_TOP_OPS)


def work(name, args, kw, out):
    """(bytes, operations, peak operations/s) of one wrapper call: each
    input tensor read once and each output written once, and the
    arithmetic its elements need."""
    outs = list(out) if isinstance(out, tuple) else [out]
    if name == "scan_i32":
        n = args[0].shape[0]
        return _nbytes(args[0], *outs), n, INT_OPS_PER_S
    if name in ("fixdups", "fixdups_carry"):   # a key read, an index written; a compare
        return _nbytes(args[0], *outs), 2 * args[0].shape[0], INT_OPS_PER_S   # and a max
    if name == "aug_fit_sums":
        # x (and y) read once, the bounds and the sums; per element of the
        # clipped ranges the sums' adds (the log form ln y once and the
        # kept count's select)
        x, y, lo, hi = args
        per = 1 if y is None else (LOG_F64_OPS + 4 if kw.get("log") else 2)
        return _nbytes(x, y, lo, hi, *outs), int((hi - lo).sum()) * per, F64_OPS_PER_S
    if name == "aug_fit_moments":
        # x (and y) read once, the bounds and the outputs; per element of
        # the augmented ranges the sums' adds, then the centered terms (xx:
        # a subtraction, a product and an add; the linear form 4 more with
        # y's conversion), at the f64 rate
        x, y, lo, hi = args
        per = 4 if y is None else 9
        return _nbytes(x, y, lo, hi, *outs), int((hi - lo).sum()) * per, F64_OPS_PER_S
    if name == "aug_fit_log_moments":
        # x and y read once, the bounds and the outputs; per element of the
        # augmented ranges ln y once (LOG_F64_OPS, though the kernel takes it
        # again where it reads a leaf twice), the count's and sums' adds and
        # the centered terms (the linear form's 9 with the weight's select)
        x, y, lo, hi = args
        return (_nbytes(x, y, lo, hi, *outs), int((hi - lo).sum()) * (LOG_F64_OPS + 10),
                F64_OPS_PER_S)
    if name in ("aug_centered_moments", "aug_centered_xx"):
        lo, hi = args[-2:]
        per = 3 if name == "aug_centered_xx" else 6
        per += 0 if kw.get("weights") is None and not kw.get("log") else 2
        per += LOG_F64_OPS if kw.get("log") else 0
        return (_nbytes(*args, kw.get("weights"), *outs), int((hi - lo).sum()) * per,
                F64_OPS_PER_S)
    if name == "lookup_clamped":
        # the keys, the top's operands (an affine top's row; an integer
        # top's packed parameters and its hint table or pivots), each
        # leaf's row and error read once (not the lookup table's padding:
        # what the function needs, not what the kernel reads), guess and
        # err written once; per query the key's conversion and
        # normalization (5), both models and their floors and clamps (8);
        # an integer top's shifts and compares counted at the f64 rate
        # (the int32 lanes' is within 2% of it)
        # (the top's operands at their model size: an integer top's hint
        # table as int32 entries, however the kernel stages it)
        q, top_w, leaf_w, leaf_errors = args[:4]
        top_bytes, top_ops = top_work(kw["top_type"], top_w)
        per = 13 + LEAF_OPS[get_model(kw["leaf_type"]).leaf_kernel] + top_ops
        return (_nbytes(q, leaf_w, leaf_errors, *outs) + top_bytes, q.shape[0] * per,
                F64_OPS_PER_S)
    if name in ("packed_search", "sorted_bounds"):
        # what the answers need, not what the kernel reads: each query (of
        # the bounds: each block's two anchors) and answer once, the top's
        # operands once, and the 32-byte sectors that decide each answer,
        # each once: of its leaf, the base and the row's samples on either
        # side of q; of keys[::64] (packed_wide) the stripe-first keys on
        # either side of lb1; of the keys (the search) keys[lb - 1] and
        # keys[lb]; per query the clip, the decode and the top (~5 + the
        # top's) and ~3 ops a halving step (int64 compares), at the f64 rate
        rmi, plan, q = args
        if name == "sorted_bounds":
            q = packed_kernel._anchors(q)
        leaf = packed_kernel._leaf_ids(rmi, plan, q)
        c1 = (packed_kernel.stripe_lower_limits(rmi, plan, q) - plan.base[leaf]) // plan.F + 1
        at = leaf * plan.rows.shape[1]
        ents = [at + (c1 - 1).clamp(0, plan.S - 1), at + c1.clamp(0, plan.S - 1)]
        per = SECTOR_BYTES // 8
        sectors = (torch.unique(torch.cat(ents) // per).numel()
                   + torch.unique(leaf // per).numel())
        steps = math.ceil(math.log2(plan.S + 1))
        if name == "packed_search":
            pairs = [(rmi.keys, out)]
            if plan.F > 1:
                pairs.append((plan.stripe_first, torch.searchsorted(plan.stripe_first, q)))
            for arr, pos in pairs:
                m = arr.shape[0]
                near = torch.cat([(pos - 1).clamp(0, m - 1), pos.clamp(0, m - 1)])
                sectors += torch.unique(near // (SECTOR_BYTES // 8)).numel()
            steps += 7 + (8 if plan.F > 1 else 0)
        top_bytes, top_ops = top_work(rmi.top_type, rmi.device_top_params)
        return (_nbytes(q, *outs) + top_bytes + SECTOR_BYTES * sectors,
                q.shape[0] * (5 + top_ops + 3 * steps), F64_OPS_PER_S)
    if name == "resolve":
        # what the answers need, not what the kernel reads (a 128-key row
        # a level): each query, guess, error and answer once, the sectors
        # of level 0 that hold keys[lb - 1] and keys[lb], each once, and
        # levels 1..K once; per query and level a binary search of its
        # 128-entry row (int64 compares, ~3 ops each)
        levels, q, guess, err = args
        keys = levels[0]
        n = keys.shape[0]
        near = torch.cat([(out - 1).clamp(0, n - 1), out.clamp(0, n - 1)])
        sectors = torch.unique(near // (SECTOR_BYTES // keys.element_size())).numel()
        nbytes = _nbytes(q, guess, err, out, *levels[1:]) + SECTOR_BYTES * sectors
        steps = (kw["K"] + 1) * math.log2(hier_kernel.WIDTH)
        return nbytes, q.shape[0] * steps * 3, INT_OPS_PER_S
    if name in ("bounded_lower_bound", "cachefix_interp"):
        # what the answers need: each query, guess, error and answer once,
        # and the 32-byte sectors that decide each answer, each once: of the
        # keys that hold keys[lb - 1] and keys[lb] (the bounded search), of
        # the knots and their values at the pair r - 1, r (the interpolation,
        # whose search ends at r); per query a halving search of its window
        # (int64 compares, ~3 ops a step) and the lerp (~12 f64 ops)
        keys, q, guess, err = (args[0], args[2], args[3], args[4]) \
            if name == "cachefix_interp" else args[:4]
        n = keys.shape[0]
        per_sector = SECTOR_BYTES // keys.element_size()
        steps = float(torch.log2((2 * err + 2).double()).ceil().mean())
        if name == "bounded_lower_bound":
            near = torch.cat([(out - 1).clamp(0, n - 1), out.clamp(0, n - 1)])
            sectors = torch.unique(near // per_sector).numel()
            return (_nbytes(q, guess, err, out) + SECTOR_BYTES * sectors,
                    q.shape[0] * steps * 3, INT_OPS_PER_S)
        res = cachefix_kernel.bounded_lower_bound_plain(keys, q, guess, err, n,
                                                        cachefix_kernel.interp_iters(n))
        r = res.clamp(1, n - 1)
        pair = torch.unique(torch.cat([r - 1, r]) // per_sector).numel()
        return (_nbytes(q, guess, err, out) + 2 * SECTOR_BYTES * pair,
                q.shape[0] * (steps * 3 + 12), F64_OPS_PER_S)
    if name in ("sweep_leaf_max", "leaf_eval_clamped"):
        per = LEAF_OPS[get_model(kw["leaf_type"]).leaf_kernel] + 4   # floor, clamps
        # K3: xn, yfix, the span bounds and the rows; K4: x, the rows, the leaf ids
        return (_nbytes(*(a for a in args if torch.is_tensor(a)), *outs),
                args[0].shape[0] * per, F64_OPS_PER_S)
    if name == "span_run_max":       # a compare, a subtraction and a max per key
        return _nbytes(*args, *outs), args[0].shape[0] * 3, INT_OPS_PER_S
    if name == "span_run_max_carry":     # the keys, targets and clips; as span_run_max
        return _nbytes(*args[:4], *outs), args[0].shape[0] * 3, INT_OPS_PER_S
    if name == "cubic_l1_sums":
        x, y, cubic_w, lin_w, spans = args
        elems = int((spans.aug_ends - spans.aug_starts).sum())
        return (_nbytes(x, y, cubic_w, lin_w, spans.aug_starts, spans.aug_ends, *outs),
                elems * 12, F64_OPS_PER_S)
    if name == "key_normalize":       # an image in, x out; the decode (4), sub, mul
        return _nbytes(args[0], *outs), args[0].shape[0] * 6, F64_OPS_PER_S
    if name == "top_l1_cubic":
        # x and yfix read once, the candidates, the two sums, the row and the
        # case written; per key the target (mul, trunc), both candidates (4
        # FMAs), two subtractions, absolutes and adds
        x, yfix, _, cand = args
        return _nbytes(x, yfix, cand, *outs), x.shape[0] * 14, F64_OPS_PER_S
    if name == "top_l1_partial":     # the same over the shard's rows below n
        x, yfix, _, cand, hi = args
        return _nbytes(x[:hi], yfix[:hi], cand, *outs), hi * 14, F64_OPS_PER_S
    if name == "top_cubic_candidates":
        # what the candidates need: the 32-byte sectors of x each of the two
        # binary searches reads (log2 n + 1 probes), the endpoints' and the
        # inner points' x, targets and key images, the buffer written; ~80
        # f64 operations (the slopes, their clamp, the coefficients)
        x = args[0]
        n = x.shape[0]
        probes = 2 * (math.ceil(math.log2(n + 1)) + 1)
        return SECTOR_BYTES * (probes + 10) + _nbytes(*outs), 80 + 3 * probes, F64_OPS_PER_S
    if name == "top_moments":
        # x and yfix over the fitted span read once (each pass reads them, the
        # centered pass after the means: twice what is counted here), the row
        # written; per key the target (mul, trunc), the two sums' adds, the
        # centered terms (2 subtractions, 2 products, 2 adds)
        top_type, x, yfix, _ = args
        lo, hi = top_kernel.top_span(top_type, x.shape[0])
        per = 12 if top_kernel.MOMENT_TOPS[top_type] == 0 else 4
        key_bytes = 12 if per == 12 else 8
        return key_bytes * (hi - lo) + _nbytes(*outs), (hi - lo) * per, F64_OPS_PER_S
    if name == "top_table_fit":
        # what the table needs: each slot's lower bound among the keys, the
        # 32-byte sectors of the images on either side of it and of its
        # target, each once; the table and (prefix, bits) written; per slot
        # a binary search of the keys (~4 integer ops a step: the bucket's
        # shifts and mask, the compare)
        images, yfix, _, bits = args
        n = images.shape[0]
        # slot b's first key: #{keys < the prefix's bits + (b << shift)}, as
        # the hint-table leaves' fit finds it (models/radix.py)
        prefix = out["w_int"][:1]
        top_bits = keymod.u64_bits(images[:1]) & ~keymod.shr(torch.full_like(prefix, -1), prefix)
        slots = torch.arange(1 << bits, device=images.device)
        at = torch.searchsorted(images, keymod.u64_bits(
            top_bits + keymod.shl(slots, radix._table_shift(prefix, bits))))
        near = torch.cat([(at - 1).clamp(0, n - 1), at.clamp(0, n - 1)])
        sectors = (torch.unique(near // (SECTOR_BYTES // 8)).numel()
                   + torch.unique(at.clamp(0, n - 1) // (SECTOR_BYTES // 4)).numel())
        steps = math.ceil(math.log2(n + 1))
        return (SECTOR_BYTES * sectors + _nbytes(out["table"], out["w_int"]),
                (1 << bits) * steps * 4, INT_OPS_PER_S)
    if name == "top_assign":
        # the top's input in, the ids out, the top's operands once; per key
        # the top and the floor and clamps (4)
        top_type, top_w, top_in = args[:3]
        top_bytes, top_ops = top_work(top_type, top_w)
        return (_nbytes(top_in, *outs) + top_bytes, top_in.shape[0] * (top_ops + 4),
                F64_OPS_PER_S)
    if name in ("serve_sorted", "serve_sorted_scatter"):
        # what the answers need, not what K5 reads: each query, window
        # bound and answer once (and the scatter's order); per answer lb
        # the sectors that hold keys[lb - 1] and keys[lb], each sector
        # once; per block a binary search of its window of stripe-first
        # keys (keys[::64], between its bounds), a sector per probe
        q, *rest = args
        order = rest.pop(0) if name == "serve_sorted_scatter" else None
        _, keys, lo, hi = rest
        n = keys.shape[0]
        near = torch.cat([(out - 1).clamp(0, n - 1), out.clamp(0, n - 1)])
        sectors = torch.unique(near // (SECTOR_BYTES // keys.element_size())).numel()
        window = (hi - lo + 1).clamp(min=1).double()
        probes = int(torch.log2(window).ceil().sum())
        nbytes = _nbytes(q, order, lo, hi, out) + SECTOR_BYTES * (sectors + probes)
        steps = math.log2(max(2.0, float(window.mean()))) + math.log2(sorted_serve_kernel.STRIPE)
        return nbytes, q.shape[0] * steps * 3, INT_OPS_PER_S      # int64 compare ~ 3 ops
    raise KeyError(name)


def library_call(name, args, kw):
    """One PyTorch call that computes the same function as the kernel,
    timed as a yardstick and used nowhere in the port, or None."""
    if name == "scan_i32":
        return (lambda: torch.cummax(args[0], 0)) if kw["is_max"] else \
            (lambda: torch.cummin(args[0], 0))
    if name == "fixdups":            # each key's first index: its lower bound among the keys
        return lambda: torch.searchsorted(args[0], args[0], out_int32=True)
    if name == "serve_sorted":
        return lambda: torch.searchsorted(args[2], args[0])
    if name == "resolve":            # the same lower bounds, from the keys alone
        return lambda: torch.searchsorted(args[0][0], args[1])
    if name == "bounded_lower_bound":    # its answer on queries whose window holds it
        return lambda: torch.searchsorted(args[0][:args[4]], args[1])
    if name == "packed_search":          # the same lower bounds, from the keys alone
        return lambda: torch.searchsorted(args[0].keys, args[2])
    return None         # the scatter entry: no one call both searches and scatters


def bound_violations(rmi, keys, sample, gen):
    idx = torch.randint(0, keys.shape[0], (sample,), generator=gen, device=keys.device)
    q = keys[idx]
    guess, err = lookup(rmi, q)
    lb = torch.searchsorted(keys, q, side="left")
    return int(((guess - lb).abs() > err).sum())


def make_queries(keys, nq, gen, key_type=KeyType.U64):
    """Random images over the key range, plus out-of-range and existing
    (duplicate) keys, all images of ``key_type`` keys: u64 from key 0 to
    2^64 - 1, u32 up to 2^32 - 1, f64 from NaN's image to +inf's."""
    dev = keys.device
    lo, hi = int(keys[0]), int(keys[-1])
    top = INF_IMAGE if key_type is KeyType.F64 else key_type.max_image
    q = torch.randint(lo, hi, (nq,), generator=gen, device=dev, dtype=torch.int64)
    k = nq // 16
    q[:k] = keys[torch.randint(0, keys.shape[0], (k,), generator=gen, device=dev)]
    q[k:k + 8] = torch.tensor([-(1 << 63), max(lo - 1, -(1 << 63)), lo, hi,
                               min(hi + 1, top), top, top - 1, min(0, top)], device=dev)
    return q


def make_f64_queries(keys, nq, gen):
    """Images of f64 values uniform over the range of the f64 keys whose
    images ``keys`` holds, 1/16 of them existing keys, and -0.0, +0.0,
    -1.0, +inf, -inf, NaN, the range's ends and the next value above it."""
    dev = keys.device
    kmin, kmax = keymod.as_float(keys[[0, -1]], KeyType.F64).tolist()
    v = torch.rand(nq, generator=gen, device=dev, dtype=torch.float64)
    q = keymod.f64_image(v.mul_(kmax - kmin).add_(kmin))
    del v
    k = nq // 16
    q[:k] = keys[torch.randint(0, keys.shape[0], (k,), generator=gen, device=dev)]
    edges = [-0.0, 0.0, -1.0, math.inf, -math.inf, math.nan, kmin, kmax,
             math.nextafter(kmax, math.inf)]
    q[k:k + len(edges)] = keymod.f64_image(torch.tensor(edges, dtype=torch.float64,
                                                        device=dev))
    return q


def mismatches(keys, q, got):
    return int((got != torch.searchsorted(keys, q, side="left")).sum())


def check_search(rmi, keys, gen):
    """search, search_sorted and fast_search on 2^16 queries (the index's
    plan; search_sorted runs K5 for a packed one) against
    torch.searchsorted."""
    q = make_queries(keys, min(1 << 16, keys.shape[0]), gen, rmi.key_type)
    qs = torch.sort(q).values
    res = {"search": mismatches(keys, q, search(rmi, q)),
           "search_sorted": mismatches(keys, qs, search_sorted(rmi, qs)),
           "fast_search": mismatches(keys, q, lookup_fast.fast_search(rmi, q))}
    log(f"search check, {q.shape[0]} queries: mismatches {json.dumps(res)}")
    if any(res.values()):
        raise RuntimeError("search disagrees with torch.searchsorted")


def serving_curve(rmi, keys, gen):
    """lookups/s per path and batch size over the main path's keys, each
    path's answers checked against torch.searchsorted once: the packed
    plan (rmi_packed_search), sort -> K5 -> unsort, search_sorted, the
    bounded route, and, for the record, the packed plan's plain route (the
    eager torch it replaced), uncounted."""
    plan = lookup_fast.get_plan(rmi)
    paths = {
        "bounded": lambda q: bounded_search(rmi, q),
        "packed": lambda q: lookup_fast.fast_search(rmi, q),
        "sort_k5": lambda q: lookup_fast.serve_via_sort(rmi, plan, q),
        "sorted_k5": lambda q: search_sorted(rmi, q),
    }
    rows = []
    for nq in CURVE:
        q = make_queries(keys, nq, gen)
        qs = torch.sort(q).values
        row = {"nq": nq}
        for name, fn in paths.items():
            x = qs if name == "sorted_k5" else q
            if mismatches(keys, x, fn(x)):
                raise RuntimeError(f"serving curve: {name} wrong at {nq} queries")
            ms = cuda_ms(lambda: fn(x), 20 if nq <= 1 << 18 else 5)
            row[name] = nq / (ms / 1e3)
        with uncounted():
            ms = cuda_ms(lambda: packed_kernel.packed_search_plain(rmi, plan, q),
                         20 if nq <= 1 << 18 else 5)
        row["packed_plain"] = nq / (ms / 1e3)
        rows.append(row)
        log(f"serving curve nq={nq}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in row.items() if k != "nq") + " lookups/s")
    over = [r["nq"] for r in rows if r["sort_k5"] > r["packed"]]
    log(f"serving curve (plan {plan.kind}, S={plan.S}, F={plan.F}): sort -> K5 "
        f"-> unsort beats the packed plan at nq in {over}")
    log("serving curve " + json.dumps(rows))


def _device_us(evt):
    """Self device time of a profiler event, 0 for a host-side op."""
    if not getattr(evt.device_type, "name", str(evt.device_type)).endswith("CUDA"):
        return 0.0
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0.0))


def stage_a_trace(data, spec, B):
    """Path 1's stages A and B on the card: a warm build traced, each
    rmi.build.* range's device ms (rmi.build.assign is stage A: FixDups,
    the model's input, the top fit, the assignment; rmi.build.fit stage
    B), then stage A alone and stage B's leaf fit alone traced as
    train_two_layer runs them, each device kernel with its calls and
    device ms, the device launches in all, and the C entries' launches:
    stage A one rmi_fixdups and one of each STAGE_A entry (the
    normalization, the cubic top's candidates and L1 sums, the
    assignment), the fit one rmi_aug_fit_moments, K1 and K2 none; returns
    the ranges' device ms."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rmi_tpu_torch.train(data, spec, B)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        rmi_tpu_torch.train(data, spec, B)
        torch.cuda.synchronize()
    ranges = {}
    for e in prof.key_averages():       # a range's host span and its device span
        if e.key.startswith("rmi.build."):
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            ranges[e.key] = max(ranges.get(e.key, 0.0), us / 1e3)
    log(f"path 1 warm build traced, device ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(ranges.items())))
    keys, key_type, (top, leaf) = data.keys, data.key_type, spec.split(",")

    def stage(label, fn, want):
        before = dict(_build.launches)
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            out = fn()
            torch.cuda.synchronize()
        moved = {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}
        kernels = sorted(((_device_us(e) / 1e3, e.count, e.key) for e in prof.key_averages()
                          if _device_us(e) > 0), reverse=True)
        log(f"path 1 {label} alone, {len(kernels)} device kernels, "
            f"{sum(k[1] for k in kernels)} launches, "
            f"{sum(k[0] for k in kernels):.4f} ms: " + "; ".join(
                f"{ms:.4f} ms x{count} {name[:72]}" for ms, count, name in kernels))
        log(f"path 1 {label} launches: {json.dumps(moved)}")
        if any(moved.get(e, 0) != c for e, c in want.items()):
            raise RuntimeError(f"path 1's {label} launched {moved}, not {want}")
        return out

    def stage_a():
        kminf, s = two_layer.norm_constants(keys, key_type)
        top_in = model_float_input(get_model(top), keys, kminf, s, key_type)
        yfix = two_layer.fixdups_i32(keys)
        _, t, _ = two_layer._assign_body(top_in, yfix, top_type=top, B=B, keys=keys,
                                         key_type=key_type)
        return top_in, yfix, t
    top_in, yfix, t = stage("stage A", stage_a, {
        "rmi_fixdups": 1, "rmi_scan_i32": 0, **{e: 1 for e in STAGE_A}})
    spans = seg.make_spans(t, B)
    next_idx = two_layer.lower_bound_fills(spans, keys, key_type)[0]
    stage("stage B's leaf fit", lambda: two_layer._fit_body(
        top_in, yfix, spans, next_idx, leaf_type=leaf, keys=keys, key_type=key_type),
        {"rmi_aug_fit_moments": 1, "rmi_aug_moments": 0})
    return ranges


def k5_phase(rmi, keys, queries):
    """K5 on the main path's batch: the share of blocks whose window
    exceeds the shared-memory stage; search's device time per batch split
    into the sort, K5's window bounds (rmi_sorted_bounds), K5 with its
    scatter and the rest (a profiler trace of SEARCH_TRACED batches)
    beside each part timed alone, and the bounds' plain version's device
    time beside its time alone; K5 at the sample levels 8 and 16 in turns
    (8, 16, 16, 8), both exact."""
    ssk = sorted_serve_kernel
    plan = lookup_fast.get_plan(rmi)
    n, nq = keys.shape[0], queries.shape[0]
    qs, order = torch.sort(queries)
    lo, hi = lookup_fast.sorted_bounds(rmi, plan, qs)
    glo, ghi = ssk.group_bounds(lo, hi, n)
    staged = ghi - (glo & ~1)
    over = int((staged > ssk.WINDOW_CAP).sum())
    log(f"K5 windows, {nq} queries over {n} keys: {over} of {lo.shape[0]} blocks "
        f"over the stage cap of {ssk.WINDOW_CAP} group-first keys (share "
        f"{over / lo.shape[0]!r}); staged keys per block mean "
        f"{float(staged.double().mean())!r}, max {int(staged.max())}")

    search(rmi, queries)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(SEARCH_TRACED):
            search(rmi, queries)
        torch.cuda.synchronize()
    parts = dict.fromkeys(("sort", "bounds", "k5_scatter", "other"), 0.0)
    for e in prof.key_averages():
        name = e.key.lower()
        part = ("k5_scatter" if "serve_sorted" in name else "bounds" if "bounds" in name
                else "sort" if "sort" in name else "other")
        parts[part] += _device_us(e) / 1e3 / SEARCH_TRACED
    # the bounds' plain version (the eager torch rmi_sorted_bounds replaced):
    # its device time a call from a trace, beside its CUDA-event time alone
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(SEARCH_TRACED):
            packed_kernel.sorted_bounds_plain(rmi, plan, qs)
        torch.cuda.synchronize()
    plain_device = sum(_device_us(e) for e in prof.key_averages()) / 1e3 / SEARCH_TRACED
    alone = {"sort": cuda_ms(lambda: torch.sort(queries), 10),
             "bounds": cuda_ms(lambda: lookup_fast.sorted_bounds(rmi, plan, qs), 10),
             "bounds_plain": cuda_ms(lambda: packed_kernel.sorted_bounds_plain(rmi, plan, qs),
                                     10),
             "k5_scatter": cuda_ms(lambda: ssk.serve_sorted_scatter(
                 qs, order, plan.group_first, keys, lo, hi), 10),
             "search": cuda_ms(lambda: search(rmi, queries), 10)}
    log(f"search device time per batch of {nq} (profiler, {SEARCH_TRACED} batches): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
        + f", busy {sum(parts.values()):.4f} ms; timed alone (CUDA events): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in alone.items())
        + f"; the bounds' plain version's device time {plain_device:.4f} ms a call")

    want = torch.searchsorted(keys, qs)
    firsts = {g: keys[::g].contiguous() for g in ssk.LEVELS}
    for g, gf in firsts.items():
        if not torch.equal(ssk.serve_sorted_level(qs, gf, keys, lo, hi, g), want):
            raise RuntimeError(f"K5 at sample level {g} disagrees with torch.searchsorted")
    times = {g: [] for g in ssk.LEVELS}
    for g in (8, 16, 16, 8):
        times[g].append(cuda_ms(lambda: ssk.serve_sorted_level(
            qs, firsts[g], keys, lo, hi, g), 10))
    library = cuda_ms(lambda: torch.searchsorted(keys, qs), 10)
    log(f"K5 sample levels, {nq} sorted queries over {n} keys, in turns 8, 16, 16, 8: "
        + ", ".join(f"level {g}: {t[0]:.4f}, {t[1]:.4f} ms" for g, t in times.items())
        + f"; torch.searchsorted {library:.4f} ms; serving uses level {ssk.GROUP}")


def same_build(a, b):
    """Two TrainedRMIs with bit-equal parameters, errors and metrics."""
    return (params_equal(a.device_top_params, b.device_top_params)
            and params_equal(a.device_leaf_params, b.device_leaf_params)
            and torch.equal(a.leaf_errors, b.leaf_errors)
            and (a.model_avg_log2_error, a.model_avg_error, a.model_max_error)
            == (b.model_avg_log2_error, b.model_avg_error, b.model_max_error))


def log_readers(keys, t, B):
    """(keys whose ln differs between the card and the CPU, [B] mask of
    the leaves that read such a value: a key of their augmented range,
    which the fit and the sweep read, or one of their two probes).
    torch's log on the card is CUDA's, on the CPU glibc's; either may
    round the last bit otherwise."""
    n, dev = keys.shape[0], keys.device
    t = t.long()

    def differs(x):
        return torch.log(x.to(dev)).cpu() != torch.log(x.cpu())

    idx = differs(keymod.as_float(keys)).nonzero().flatten()
    spans = seg.make_spans(t.to(torch.int32), B)
    direct = torch.zeros(B, dtype=torch.bool)
    # its own leaf, and the leaf before or after it where it is an edge key
    for nb in ((idx - 1).clamp(min=0), idx, (idx + 1).clamp(max=n - 1)):
        direct[t[nb]] = True
    _, next_key, prev_key = two_layer.lower_bound_fills(spans, keys.cpu(), KeyType.U64)
    probes = torch.cat([keymod.minus_epsilon(next_key, KeyType.U64),
                        keymod.plus_epsilon(prev_key, KeyType.U64)])
    direct |= differs(keymod.as_float(probes)).view(2, B).any(0)
    return int(idx.numel()), direct


def typed_keys(u, key_type):
    """Sorted images of ``key_type`` keys made from books_like_on_device's
    u64 images ``u``: the u64 keys themselves; as path 8's u32 keys, each
    shifted right by 30 (the books_200M_uint32 shape); as path 7's f64
    keys, each cast to f64 (one rounding, the same bits in every run) and
    scaled by 2^-32, exactly, to [0, 2^30]."""
    if key_type is KeyType.F64:
        return keymod.f64_image(keymod.as_float(u).mul_(2.0 ** -32))
    if key_type is KeyType.U32:
        return (keymod.u64_bits(u) >> 30).add_(keymod.IMAGE_MIN)   # u >> 30 < 2^32
    return u


def floor_flips(card, cpu, keys, t, B, key_type):
    """([B] mask, float): the leaves where the card's leaf rows and the
    CPU's, run through the same plain K4 on the CPU, floor a key of the
    leaf or one of its two epsilon probes to another position, where a
    fit's last-bit rounding moves the leaf's error by 1; and the largest
    gap between the two rows' unfloored predictions at the keys.  Where
    leaves hold a key or two, a leaf's line runs through its keys'
    positions, so its predictions sit on whole numbers and either rounding
    may floor one below."""
    mleaf = get_model(cpu.leaf_type)
    n, keys, t = keys.shape[0], keys.cpu(), t.long()
    spans = seg.make_spans(t.to(torch.int32), B)
    _, next_key, prev_key = two_layer.lower_bound_fills(spans, keys, key_type)
    builds = ((params_to(card.device_leaf_params, "cpu"), card), (cpu.device_leaf_params, cpu))

    def floors(k, ids):
        a, b = [eval_kernel.leaf_eval_clamped_plain(
            kernel_input(mleaf, model_float_input(mleaf, k, r.norm_offset, r.norm_scale,
                                                  key_type)),
            w, ids, n, leaf_type=cpu.leaf_type) for w, r in builds]
        return a != b

    xs = [kernel_input(mleaf, model_float_input(mleaf, keys, r.norm_offset, r.norm_scale,
                                                key_type)) for _, r in builds]
    gap = float((leaf_predict(cpu.leaf_type, builds[0][0], t, xs[0])
                 - leaf_predict(cpu.leaf_type, builds[1][0], t, xs[1])).abs().max())
    flips = torch.zeros(B, dtype=torch.bool)
    flips[t[floors(keys, t)]] = True
    leaf_ids = torch.arange(B)
    for probe in (keymod.minus_epsilon(next_key, key_type),
                  keymod.plus_epsilon(prev_key, key_type)):
        flips |= floors(probe, leaf_ids)
    return flips, gap


def cross_check(spec, n, B, seed, dev, rec=None, key_type=KeyType.U64, sparse=False,
                keys=None, line=None):
    """A build on the card against the plain build on the CPU, same keys
    (books-like ones from ``seed``, or ``keys``, images on the card);
    with ``line``, train_bounded on both sides, whose knots must be equal,
    and the RMIs over the knots compared; the card build's kernel calls
    are recorded into ``rec`` if given.
    Leaf errors may differ by 1 from the order of sums in a few leaves.
    A lognormal leaf fits and predicts on ln x, so a leaf that reads a
    value whose log the card rounds otherwise may differ too
    (log_readers); and its mean is a difference of prefix sums of ln x
    (~43 per key), good to ~1e-10 against a stdev of ~1e-5 at 64 keys
    per leaf, so a leaf whose row the card's sums round otherwise may
    differ by 1 however few they are.  With ``sparse`` (a key or two a
    leaf), so may a leaf whose keys or probes the two builds' rows floor to
    other positions (floor_flips).  Such leaves are counted apart."""
    if keys is None:
        keys = typed_keys(rdata.books_like_on_device(n, seed, dev), key_type)

    def build(k):
        if line is None:
            return rmi_tpu_torch.train(rdata.RMIDataset(k, key_type), spec, B)
        return rmi_tpu_torch.train_bounded(rdata.RMIDataset(k, key_type), spec, B, line)

    with rec or contextlib.nullcontext():
        card = build(keys)
    cpu = build(keys.cpu())
    if line is not None:      # the spline runs on the host: the same knots
        same_knots = all(np.array_equal(a, b) for a, b in zip(card.cache_fix, cpu.cache_fix))
        log(f"cross-check {spec} --bounded {line}: {len(cpu.cache_fix[1])} knots over "
            f"{n} keys, card and CPU knots equal {same_knots}")
        if not same_knots:
            raise RuntimeError(f"{spec}: the card's spline knots differ from the CPU's")
        keys, n = card.keys, card.num_rmi_rows

    def ids_counts(r, k):
        t = two_layer.top_assignment(get_model(r.top_type), r.device_top_params, k,
                                     r.norm_offset, r.norm_scale, B - 1, key_type)
        spans = seg.make_spans(t, B)
        return t.cpu(), (spans.ends - spans.starts).cpu()

    t_card, cnt_card = ids_counts(card, keys)
    t_cpu, cnt_cpu = ids_counts(cpu, keys.cpu())
    e_card, e_cpu = card.leaf_errors.cpu(), cpu.leaf_errors.cpu()
    id_diff = (t_card - t_cpu).abs()
    err_diff = (e_card - e_cpu).abs()
    leaves = (err_diff > 0) | (cnt_card != cnt_cpu)
    flips = torch.zeros(B, dtype=torch.bool)
    if sparse:
        flips, gap = floor_flips(card, cpu, keys, t_cpu, B, key_type)
    reading = flips.clone()

    def contrib(cnt, e):
        return cnt.double() * torch.log2(2.0 * e.double() + 2.0)
    explained = float((contrib(cnt_card, e_card) - contrib(cnt_cpu, e_cpu))[leaves]
                      .abs().sum()) / n
    d_log2 = abs(card.model_avg_log2_error - cpu.model_avg_log2_error)
    res = {"spec": spec, "keys": key_type.value, "n": n, "B": B,
           "max_err_card": card.model_max_error,
           "max_err_cpu": cpu.model_max_error,
           "avg_log2_card": card.model_avg_log2_error,
           "avg_log2_cpu": cpu.model_avg_log2_error,
           "avg_log2_abs_diff": d_log2, "explained_by_differing_leaves": explained,
           "leaf_ids_differing": int((id_diff > 0).sum()),
           "leaf_ids_max_diff": int(id_diff.max()),
           "leaf_errors_differing": int((err_diff > 0).sum()),
           "leaf_errors_max_diff": int(err_diff.max()),
           "top_params_equal": params_equal(params_to(card.device_top_params, "cpu"),
                                            cpu.device_top_params)}
    if get_model(cpu.leaf_type).input_domain == "raw":
        res["keys_log_differs"], direct = log_readers(keys, t_cpu, B)
        a, b = card.device_leaf_params.cpu(), cpu.device_leaf_params
        refit = ~((a == b) | (a.isnan() & b.isnan())).all(1) & ~direct
        reading |= direct | refit
        res["leaves_reading_them"] = int(direct.sum())
        res["leaf_rows_differing_otherwise"] = int(refit.sum())
        res["differing_leaves_reading_them"] = int((direct & (err_diff > 0)).sum())
        res["differing_leaves_rows_differing"] = int((refit & (err_diff > 0)).sum())
    if sparse:
        res["leaves_flooring_otherwise"] = int(flips.sum())
        res["differing_leaves_flooring_otherwise"] = int((flips & (err_diff > 0)).sum())
        res["largest_prediction_gap"] = gap
    res["leaf_errors_differing_otherwise"] = int(((err_diff > 0) & ~reading).sum())
    few = max(8, B // 256)
    log("cross-check " + json.dumps(res))
    ok = (res["max_err_card"] == res["max_err_cpu"]
          and d_log2 <= METRIC_RTOL * abs(cpu.model_avg_log2_error) + explained
          and res["leaf_ids_max_diff"] <= 1 and res["leaf_errors_max_diff"] <= 1
          and res["leaf_ids_differing"] <= few
          and res["leaf_errors_differing_otherwise"] <= few)
    if not ok:
        raise RuntimeError(f"{spec}: card build and CPU build disagree beyond tolerance")


def launched(fn):
    """(fn()'s result, {entry: launches} of the C entries fn launched)."""
    before = dict(_build.launches)
    out = fn()
    torch.cuda.synchronize()
    return out, {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}


def drive(path, data, queries, gen):
    """Phases 3-5 of one path: cold and warm builds with the launches
    counted from 0 and every call of a kernel wrapper recorded, the bound
    check, search and search_sorted; returns (index, recorder, launches)."""
    spec, B, entries, _ = path
    keys = data.keys
    nq = queries.shape[0]
    queries_sorted = torch.sort(queries).values
    for entry in _build.launches:
        _build.launches[entry] = 0
    torch.cuda.reset_peak_memory_stats()
    with Recorder() as rec:
        t0 = time.perf_counter()
        rmi = rmi_tpu_torch.train(data, spec, B)
        cold = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    warm_rmi = rmi_tpu_torch.train(data, spec, B)
    warm = time.perf_counter() - t0
    with rec:
        viol, by_lookup = launched(lambda: bound_violations(rmi, keys, nq, gen))
        lookup(rmi, queries)         # replayed with the sampled keys' lookup
        # made before search's launches are counted: a packed plan's leaf
        # spans assign the keys (rmi_key_normalize, rmi_top_assign)
        plan, by_plan = launched(lambda: lookup_fast.get_plan(rmi))
        idx, by_search = launched(lambda: search(rmi, queries))
        idx_sorted, by_sorted = launched(lambda: search_sorted(rmi, queries_sorted))
        if plan.kind != "hier":
            idx_fast, by_fast = launched(lambda: lookup_fast.fast_search(rmi, queries))
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    kernel = get_model(rmi.leaf_type).leaf_kernel
    # the fused entry, or for an integer top the per-element one
    fused = (f"rmi_lookup_{kernel}" if eval_kernel.fused_lookup(rmi.top_type, rmi.leaf_type)
             else f"rmi_leaf_eval_{kernel}")
    log(f"{spec} lookup launches: {json.dumps(by_lookup)}")
    if by_lookup != {fused: 1}:
        raise RuntimeError(f"{spec}: lookup launched {by_lookup}, not {fused} alone")
    log(f"build {spec} {B}: cold {cold:.4f} s, warm {warm:.4f} s, peak device "
        f"memory {peak / 2**30:.2f} GiB; model_max_error {rmi.model_max_error} "
        f"at leaf {rmi.model_max_error_idx}, RMI_SIZE {rmi_size(rmi)}, "
        f"model_avg_log2_error {rmi.model_avg_log2_error!r}, "
        f"model_avg_error {rmi.model_avg_error!r}")
    log(f"{spec} launches: {json.dumps(launches)}; the plan's {json.dumps(by_plan)}")
    missing = [e for e in entries if launches[e] <= 0]
    if missing:
        raise RuntimeError(f"{spec}: kernels not launched on the path: {missing}")
    if (plan.kind != "hier" and get_model(rmi.top_type).input_domain != "raw"
            and by_plan.get("rmi_top_assign") != 1):
        raise RuntimeError(f"{spec}: the plan's leaf spans launched {by_plan}, "
                           "not rmi_top_assign once")
    if not math.isfinite(rmi.model_avg_log2_error) or rmi.leaf_errors.shape != (B,):
        raise RuntimeError(f"{spec}: build produced malformed metrics")
    builds_again = same_build(rmi, warm_rmi)
    log(f"{spec} reproducible: cold and warm builds bit-equal {builds_again}")
    if not builds_again:
        raise RuntimeError(f"{spec}: the same keys gave different builds")
    del warm_rmi

    log(f"{spec} bound check: {viol} violations on {nq} sampled keys")
    if viol:
        raise RuntimeError("bound |guess - lb| <= err violated")
    mism = mismatches(keys, queries, idx)
    mism_sorted = mismatches(keys, queries_sorted, idx_sorted)
    mism_fast = 0 if plan.kind == "hier" else mismatches(keys, queries, idx_fast)
    log(f"{spec} search check: {mism} mismatches on {nq} queries, search_sorted "
        f"{mism_sorted}, fast_search {mism_fast}; plan {plan.kind} S={plan.S} F={plan.F}")
    if mism or mism_sorted or mism_fast:
        raise RuntimeError("search disagrees with torch.searchsorted")
    if plan.kind != "hier":
        serving_launches(spec, search_route(rmi, nq), by_search, by_sorted, by_fast)
    check_search(rmi, keys, gen)
    ms = cuda_ms(lambda: search(rmi, queries), 5)
    log(f"{spec} search: {nq / (ms / 1e3):.6g} lookups/s ({ms:.4f} ms per batch "
        f"of {nq})")
    return rmi, rec, launches


def serving_launches(spec, route, by_search, by_sorted, by_fast):
    """A packed plan's serving launches: fast_search rmi_packed_search
    alone, search_sorted rmi_sorted_bounds and then K5, search as its
    route says (the sort: rmi_sorted_bounds and K5's scatter entry)."""
    want_search = ({"rmi_sorted_bounds": 1, "rmi_serve_sorted_scatter": 1} if route == "sort"
                   else {"rmi_packed_search": 1})
    log(f"{spec} serving launches: search ({route}) {json.dumps(by_search)}, search_sorted "
        f"{json.dumps(by_sorted)}, fast_search {json.dumps(by_fast)}")
    if (by_fast != {"rmi_packed_search": 1} or by_search != want_search
            or by_sorted != {"rmi_sorted_bounds": 1, "rmi_serve_sorted": 1}):
        raise RuntimeError(f"{spec}: a packed plan's serving launched other kernels")


def packed_line(label, rmi, q):
    """A packed plan's search of ``q``: rmi_packed_search timed beside its
    plain version (the eager route it replaced), torch.searchsorted and
    its bound, both exact; the launches uncounted."""
    plan = lookup_fast.get_plan(rmi)
    args = (rmi, plan, q)
    with uncounted():
        got = packed_kernel.packed_search(*args)
        mism = (mismatches(rmi.keys, q, got),
                mismatches(rmi.keys, q, packed_kernel.packed_search_plain(*args)))
        ms = row_ms(lambda: packed_kernel.packed_search(*args), 10)
        plain = row_ms(lambda: packed_kernel.packed_search_plain(*args), 3)
        library = row_ms(lambda: torch.searchsorted(rmi.keys, q), 10)
    bound_ms, bound_by, _, _ = bound_of("packed_search", args, {}, got)
    log(f"{label} packed search ({plan.kind} S={plan.S} F={plan.F}) of {q.shape[0]} "
        f"queries: kernel {spread(ms)}, plain {spread(plain)}, torch.searchsorted "
        f"{spread(library)}, bound {bound_ms:.4f} ms ({bound_by}), share "
        f"{bound_ms / ms[0]:.3f}; mismatches {mism}")
    if any(mism):
        raise RuntimeError(f"{label}: the packed search disagrees with torch.searchsorted")


def zoo_row(data, row, gen, nq, cross_n, seed, dev):
    """One zoo row on ``data``'s keys: one build (the kernels long built),
    its metrics and build time, the bound on nq sampled keys, whose lookup
    must launch the fused entry once where eval_kernel.fused_lookup holds
    and nothing else, search on 2^16 queries (for a hier plan through
    rmi_hier_resolve), the fused lookup of nq sampled keys timed beside
    the two-step route, the entries it replays, then its card-vs-CPU
    cross-check.  max_err near n is the models' own (rmi_tpu finds it on
    the TPU too), not a failure."""
    spec, B, replayed = row
    keys = data.keys
    n = keys.shape[0]
    torch.cuda.synchronize()
    with Recorder() as rec:
        t0 = time.perf_counter()
        rmi = rmi_tpu_torch.train(data, spec, B)
        secs = time.perf_counter() - t0
        plan = lookup_fast.get_plan(rmi)
        log(f"zoo {spec} {B} ({data.key_type.value} keys): build {secs:.4f} s; "
            f"model_max_error {rmi.model_max_error} at leaf {rmi.model_max_error_idx}, "
            f"RMI_SIZE {rmi_size(rmi)}, model_avg_log2_error "
            f"{rmi.model_avg_log2_error!r}; plan {plan.kind} S={plan.S} F={plan.F}")
        if not math.isfinite(rmi.model_avg_log2_error) or rmi.leaf_errors.shape != (B,):
            raise RuntimeError(f"{spec}: build produced malformed metrics")
        viol, by_lookup = launched(lambda: bound_violations(rmi, keys, nq, gen))
        kernel = get_model(rmi.leaf_type).leaf_kernel
        fused = eval_kernel.fused_lookup(rmi.top_type, rmi.leaf_type)
        # the two steps: K4's per-element entry after the torch top, or for
        # hint-table leaves nothing, each after rmi_key_normalize where the
        # top or the leaf takes normalized keys
        want = ({f"rmi_lookup_{kernel}": 1} if fused
                else {f"rmi_leaf_eval_{kernel}": 1} if kernel else {})
        if not fused and "affine" in (get_model(rmi.top_type).input_domain,
                                      get_model(rmi.leaf_type).input_domain):
            want["rmi_key_normalize"] = 1
        log(f"zoo {spec} bound check: {viol} violations on {nq} sampled keys; lookup "
            f"launches {json.dumps(by_lookup)}")
        if viol:
            raise RuntimeError(f"{spec}: bound |guess - lb| <= err violated")
        if by_lookup != want:
            raise RuntimeError(f"{spec}: lookup launched {by_lookup}, not {want}")
        _, by_search = launched(lambda: check_search(rmi, keys, gen))
        if plan.kind == "hier" and by_search.get("rmi_hier_resolve", 0) <= 0:
            raise RuntimeError(f"{spec}: the hier plan's search launched {by_search}")
        if plan.kind == "hier":      # the images just past either end and the ends
            edge = torch.cat([keys[:1] - 1, keys[:1], keys[-1:], keys[-1:] + 1])
            got, want = search(rmi, edge), torch.searchsorted(keys, edge)
            log(f"zoo {spec} search past the ends: queries {edge.tolist()}, answers "
                f"{got.tolist()}, lower bounds {want.tolist()}")
            if not torch.equal(got, want):
                raise RuntimeError(f"{spec}: search past the keys' ends is not exact")
        if plan.kind != "hier":      # at the paths' batch, recorded and replayed
            q = make_queries(keys, nq, gen, data.key_type)
            qs = torch.sort(q).values
            _, by_fast = launched(lambda: lookup_fast.fast_search(rmi, q))
            _, by_sorted = launched(lambda: search_sorted(rmi, qs))
            _, by_sort = launched(lambda: lookup_fast.serve_via_sort(rmi, plan, q))
            serving_launches(f"zoo {spec}", "sort", by_sort, by_sorted, by_fast)
    if plan.kind != "hier":
        packed_line(f"zoo {spec}", rmi, q)
        del q, qs
    if fused:        # the fused lookup's time beside its bound and the two steps
        sample = keys[torch.randint(0, n, (nq,), generator=gen, device=keys.device)]
        args = (sample, rmi.device_top_params, rmi.device_leaf_params, rmi.leaf_errors,
                rmi.num_rmi_rows, rmi.norm_offset, rmi.norm_scale)
        def two_steps():
            return eval_kernel.lookup_steps(*args, rmi.top_type, rmi.leaf_type,
                                            eval_kernel.leaf_eval_clamped, rmi.key_type)
        out = lookup(rmi, sample)
        same_as_steps(f"zoo {spec}", out, two_steps())
        kw = {"top_type": rmi.top_type, "leaf_type": rmi.leaf_type, "key_type": rmi.key_type,
              "table": rmi.lookup_table_cache, "top_args": rmi.lookup_top_cache}
        fused = row_ms(lambda: eval_kernel.lookup_clamped(*args, **kw), 10)
        steps = row_ms(two_steps, 10)
        log(f"zoo {spec} lookup of {nq} sampled keys: fused {spread(fused)}, two steps "
            f"{spread(steps)}")
        if get_model(rmi.top_type).output_int:
            pk = {k: kw[k] for k in ("top_type", "leaf_type", "key_type")}
            plain = row_ms(lambda: eval_kernel.lookup_clamped_plain(*args, **pk), 3)
            int_lookup_line(spec, fused, bound_of("lookup_clamped", args, kw, out)[0], plain,
                            kw)
        del sample, args, out
    del rmi
    check_kernels(rec, {}, replayed, timed=False)
    del rec
    torch.cuda.empty_cache()
    cross_check(spec, cross_n, max(64, (B * cross_n) // n), seed, dev,
                key_type=data.key_type)


def zoo_phase(data, gen, nq, cross_n, seed, dev):
    """The ZOO rows on the main path's keys (zoo_row)."""
    for i, row in enumerate(ZOO):
        zoo_row(data, row, gen, nq, cross_n, seed + i, dev)


# path 6: the compile path through the CLI on the paths' keys
PATH6A = ("cubic,linear", 262144)
PATH6B = ("linear_spline,linear", 4194304, 8)
# SOSD_SYNTH.json's simple_model_wiki row: the size does not follow the keys
PATH6A_RMI_SIZE = 6291488
PATH6_SAMPLE = 1 << 16            # keys and queries each for the native and C++ checks
# every entry path 6 launches: the train (6a and 6b), lookup and search
# on the loaded artifact (6a), lookup over the knots (6b); and the ones
# replayed on 6a's serving calls and 6b's calls
PATH6 = ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
         "rmi_leaf_eval_linear", "rmi_lookup_linear", *K5, "rmi_cachefix_interp",
         "rmi_bounded_lower_bound")
PATH6B_LAUNCHES = ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
                   "rmi_leaf_eval_linear", "rmi_lookup_linear", "rmi_cachefix_interp",
                   "rmi_bounded_lower_bound")

CPP_HARNESS = textwrap.dedent("""
    #include "{ns}.h"
    #include <algorithm>
    #include <cstdio>
    #include <cstdint>
    #include <vector>

    static std::vector<{key_c}> read_sosd(const char* path) {{
      FILE* f = fopen(path, "rb");
      uint64_t n = 0;
      if (f == nullptr || fread(&n, 8, 1, f) != 1) return {{}};
      std::vector<{key_c}> v(n);
      if (fread(v.data(), sizeof({key_c}), n, f) != n) v.clear();
      fclose(f);
      return v;
    }}

    int main(int argc, char** argv) {{
      // argv: data_dir keys_file queries_file out_file
      if (!{ns}::load(argv[1])) {{ printf("LOAD FAIL\\n"); return 2; }}
      std::vector<{key_c}> keys = read_sosd(argv[2]), q = read_sosd(argv[3]);
      if (keys.empty() || q.empty()) return 3;
      FILE* out = fopen(argv[4], "wb");
      for ({key_c} x : q) {{
        size_t err;
        uint64_t guess = {ns}::lookup(x, &err);
        uint64_t lo = guess > err ? guess - err : 0;
        uint64_t hi = std::min<uint64_t>(guess + err + 1, keys.size());
        uint64_t lb = std::lower_bound(keys.begin() + std::min<uint64_t>(lo, hi),
                                       keys.begin() + hi, x) - keys.begin();
        uint64_t row[3] = {{guess, (uint64_t)err, lb}};
        fwrite(row, 8, 3, out);
      }}
      fclose(out);
      {ns}::cleanup();
      printf("RMI_SIZE=%zu\\n", {ns}::RMI_SIZE);
      return 0;
    }}
""")


class Walls:
    """Wall seconds of each path of the run, logged as each one ends, with
    the run's total so far."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def lap(self, label):
        now = time.perf_counter()
        log(f"wall {label}: {now - self.last:.1f} s (run total {now - self.start:.1f} s)")
        self.last = now


class Timers:
    """Wall seconds of named calls, timed by wrapping the functions the
    CLI reaches (restored on exit); ``last`` keeps each one's last
    result."""

    def __init__(self, targets):
        self.targets, self.seconds, self.last, self._saved = targets, {}, {}, []

    def __enter__(self):
        for label, (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))

            def timed(*a, _fn=fn, _label=label, **kw):
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.seconds[_label] = self.seconds.get(_label, 0.0) + \
                    time.perf_counter() - t0
                self.last[_label] = out
                return out
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)

    def line(self):
        return ", ".join(f"{k} {v:.3f} s" for k, v in self.seconds.items())


def sample_keys_and_queries(keys, count, gen):
    """``count`` keys drawn from ``keys`` and ``count`` uniform queries over
    their range, as one batch of images."""
    lo, hi = int(keys[0]), int(keys[-1])
    k = keys[torch.randint(0, keys.shape[0], (count,), generator=gen, device=keys.device)]
    q = torch.randint(lo, hi, (count,), generator=gen, device=keys.device,
                      dtype=torch.int64)
    return torch.cat([k, q])


def run_cli(workdir, argv, timers):
    """rmi_tpu_torch.cli.main(argv) in ``workdir`` on the card, timed."""
    with contextlib.chdir(workdir), Timers(timers) as t:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        total = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main({argv}) returned {rc}")
    return total, t


def compiled_cpp(workdir, ns, meta_dir, keys_file, queries, key_type):
    """The generated ``ns.cpp`` built with g++ -O3 beside the harness above,
    run over ``queries`` (numpy keys of ``key_type``) and the keys file:
    (guess, err, lb), RMI_SIZE and the seconds of the build and the run."""
    with open(os.path.join(workdir, "harness.cpp"), "w") as f:
        f.write(CPP_HARNESS.format(ns=ns, key_c=key_type.c_type))
    exe = os.path.join(workdir, "harness")
    t0 = time.perf_counter()
    subprocess.run([shutil.which("g++") or "g++", "-O3", "-std=c++17", "-o", exe,
                    os.path.join(workdir, "harness.cpp"),
                    os.path.join(workdir, f"{ns}.cpp"), "-I", workdir],
                   check=True, capture_output=True)
    built = time.perf_counter() - t0
    qf, of = os.path.join(workdir, f"queries_{ns}"), os.path.join(workdir, "out.bin")
    rdata.write_sosd_file(qf, queries)
    t0 = time.perf_counter()
    r = subprocess.run([exe, meta_dir, keys_file, qf, of], check=True,
                       capture_output=True, text=True)
    ran = time.perf_counter() - t0
    size = int(next(ln for ln in r.stdout.splitlines() if "RMI_SIZE" in ln).split("=")[1])
    out = np.fromfile(of, dtype="<u8").reshape(-1, 3).astype(np.int64)
    return out[:, 0], out[:, 1], out[:, 2], size, built, ran


def host_checks(path, label, guess, err, idx, q_img, keys, card_guess):
    """Bound violations and search mismatches of a host server's answers
    (numpy) for queries ``q_img`` (their lower bounds from the card), and
    how many guesses differ from the card's: the count is logged, the
    violations and mismatches must be 0."""
    lb = torch.searchsorted(keys, q_img, side="left").cpu().numpy()
    viol = int((np.abs(guess - lb) > err).sum())
    mism = int((idx != lb).sum())
    differ = int((guess != card_guess).sum())
    log(f"{path} {label}: {viol} bound violations, {mism} search mismatches on "
        f"{lb.shape[0]} keys and queries; {differ} guesses differ from the card's")
    if viol or mism:
        raise RuntimeError(f"{path} {label}: bound or search broken")
    return differ


def cli_path(label, tmp, path, ns, data, keys_np, queries, gen, ref, rec):
    """``cubic,linear 262144`` (path 1's spec) through the CLI on the SOSD
    file ``path`` of ``data``'s keys (``keys_np`` on the host): RMI_SIZE
    6291488, the metrics ``ref["metrics"]`` of the card build of the same
    keys, the artifact loaded back onto the card (its serving calls
    recorded into ``rec``) serving ``queries`` as the card build's index
    ``ref`` does where the query keeps its leaf, search and search_sorted
    exact; the native server and the generated C++ (keys of the file's
    type) on PATH6_SAMPLE sampled keys and as many queries: 0 bound
    violations and exact search.  Returns the sampled keys and queries."""
    keys, kt = data.keys, data.key_type
    spec, B = PATH6A
    total, t = run_cli(tmp, [path, ns, spec, str(B), "--stats-file", f"stats_{ns}.json",
                             "--data-path", "rmi_data", "--zero-build-time"], {
        "load": (rmi_tpu_torch, "load_data"), "train": (rmi_tpu_torch, "train"),
        "output_rmi": (rmi_tpu_torch, "output_rmi"),
        "transfer and raw conversion": (train_api, "_raw_params"),
        "blobs and metadata (the transfer included)": (serialize, "save_artifact"),
        "codegen": (codegen, "generate_cpp")})
    stats = json.load(open(os.path.join(tmp, f"stats_{ns}.json")))
    meta_path = os.path.join(tmp, "rmi_data", f"{ns}.json")
    meta = json.load(open(meta_path))
    log(f"{label} cli {spec} {B} ({meta['key_type']} keys): {total:.3f} s ({t.line()}); "
        f"RMI_SIZE {stats['size binary search']}, max error {stats['max error']} at leaf "
        f"{meta['metrics']['model_max_error_idx']}, average log2 error "
        f"{stats['average log2 error']!r}; files "
        f"{sorted(os.listdir(tmp))} rmi_data "
        f"{sorted(os.listdir(os.path.join(tmp, 'rmi_data')))}")
    if stats["size binary search"] != PATH6A_RMI_SIZE:
        raise RuntimeError(f"{label}: RMI_SIZE {stats['size binary search']}, not "
                           f"{PATH6A_RMI_SIZE}")
    got = (stats["max error"], meta["metrics"]["model_max_error_idx"],
           stats["average log2 error"])
    if got != ref["metrics"]:
        raise RuntimeError(f"{label}: metrics {got} differ from the card build's "
                           f"{ref['metrics']}")
    if meta["key_type"] != kt.value or f"lookup({kt.c_type} key" not in open(
            os.path.join(tmp, f"{ns}.h")).read():
        raise RuntimeError(f"{label}: the artifact or {ns}.h does not carry "
                           f"{kt.value} keys")
    del t

    with rec:
        t0 = time.perf_counter()
        loaded = rmi_tpu_torch.load_artifact(meta_path, keys=keys)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        g, e = lookup(loaded, queries)
        idx = search(loaded, queries)
        qs = torch.sort(queries).values
        idx_sorted = search_sorted(loaded, qs)
    # bit-equal to the card build's index wherever the loaded top routes
    # the query to the same leaf; the raw round trip may move a query that
    # lies on a leaf boundary (tests/test_torch_artifacts.py)
    moved = ref["leaf"] != top_leaf(loaded, queries)
    same = ~moved
    differ = int(((g != ref["lookup"][0]) | (e != ref["lookup"][1]))[same].sum())
    mism = mismatches(keys, queries, idx) + mismatches(keys, qs, idx_sorted)
    log(f"{label} load_artifact onto the card {load_s:.3f} s; lookup of the "
        f"{queries.shape[0]} queries: {differ} differ from the card build's index where "
        f"the leaf is the same, {int(moved.sum())} queries moved to another leaf by the "
        f"round trip; search and search_sorted {mism} mismatches")
    if differ or mism:
        raise RuntimeError(f"{label}: the loaded artifact serves otherwise than the "
                           f"card build")

    sample = sample_keys_and_queries(keys, PATH6_SAMPLE, gen)
    q_np = keymod.from_image(sample, kt)
    card_g = lookup(loaded, sample)[0].cpu().numpy()
    t0 = time.perf_counter()
    built_before = os.path.exists(native.library_path())
    native.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv = native.NativeRMI(meta_path)
    native_s = time.perf_counter() - t0
    with srv:
        ng, ne = srv.lookup(q_np)
        nidx = srv.search(q_np, keys_np)
    log(f"{label} native server: library {native.library_path()} "
        f"{'found' if built_before else 'built'} in {build_s:.3f} s, the artifact "
        f"loaded in {native_s:.3f} s")
    host_checks(label, "native server", ng.astype(np.int64), ne.astype(np.int64),
                nidx.astype(np.int64), sample, keys, card_g)
    cg, ce, cidx, csize, built, ran = compiled_cpp(tmp, ns, os.path.join(tmp, "rmi_data"),
                                                   path, q_np, kt)
    log(f"{label} {ns}.cpp: g++ -O3 {built:.3f} s, run {ran:.3f} s, RMI_SIZE {csize}; "
        f"{int((cg != ng.astype(np.int64)).sum())} guesses differ from the native "
        f"server's")
    host_checks(label, "compiled C++", cg, ce, cidx, sample, keys, card_g)
    if csize != PATH6A_RMI_SIZE:
        raise RuntimeError(f"{label}: {ns}.cpp's RMI_SIZE {csize}")
    del loaded, g, e, idx, idx_sorted, qs, srv
    torch.cuda.empty_cache()
    return sample


def compile_phase(data, queries, gen, p1):
    """Path 6 on the paths' keys through the CLI, in a temporary directory
    deleted at the end; returns its recorder and launches (6a and 6b)."""
    keys = data.keys
    n = keys.shape[0]
    for entry in _build.launches:
        _build.launches[entry] = 0
    rec = Recorder()
    with tempfile.TemporaryDirectory(prefix="rmi_chip_smoke_") as tmp:
        t0 = time.perf_counter()
        keys_np = data.to_numpy()
        path = os.path.join(tmp, f"books_{n}_uint64")
        rdata.write_sosd_file(path, keys_np)
        log(f"path 6: {n} keys written to an SOSD file in "
            f"{time.perf_counter() - t0:.3f} s (the card-to-host copy included)")

        # 6a: cubic,linear 262144, as path 1, through the CLI
        sample = cli_path("path 6a", tmp, path, "books", data, keys_np, queries, gen, p1,
                          rec)

        # 6b: linear_spline,linear 4194304 --bounded 8 on the same file
        spec_b, B_b, line = PATH6B
        with rec:
            before_b = dict(_build.launches)
            total, t = run_cli(tmp, [path, "cfw", spec_b, str(B_b), "--bounded", str(line),
                                     "--stats-file", "stats_b.json", "--data-path",
                                     "rmi_data", "--zero-build-time"], {
                "load": (rmi_tpu_torch, "load_data"),
                "unique (run starts on the card, then to the host)":
                    (rdata.RMIDataset, "unique"),
                "spline (native, host)": (native, "cache_fix"),
                "train over the knots": (train_api, "train"),
                "train_bounded": (rmi_tpu_torch, "train_bounded"),
                "output_rmi": (rmi_tpu_torch, "output_rmi")})
            stats_b = json.load(open(os.path.join(tmp, "stats_b.json")))
            meta_b_path = os.path.join(tmp, "rmi_data", "cfw.json")
            knots = json.load(open(meta_b_path))["cache_fix"]["num_points"]
            want_size = 16 + 24 * B_b + 16 * knots
            log(f"path 6b cli {spec_b} {B_b} --bounded {line}: {total:.3f} s ({t.line()}); "
                f"{knots} knots, RMI_SIZE {stats_b['size binary search']} (want "
                f"{want_size}), max error over the knots {stats_b['max error']}")
            if stats_b["size binary search"] != want_size:
                raise RuntimeError("path 6b: RMI_SIZE is not 16 + 24 B + 16 knots")
            del t
            bounded = rmi_tpu_torch.load_artifact(meta_b_path)
            idx = torch.randint(0, n, (queries.shape[0],), generator=gen, device=keys.device)
            sk = keys[idx]
            pos, err = lookup(bounded, sk)
            found = search(bounded, sk, keys=keys)
        torch.cuda.synchronize()
        missing = [e for e in PATH6B_LAUNCHES if _build.launches[e] <= before_b[e]]
        if missing:
            raise RuntimeError(f"path 6b: kernels not launched: {missing}")
        lb = torch.searchsorted(keys, sk, side="left")
        viol = int(((pos - lb).abs() > line).sum())
        mism = int((found != lb).sum())
        log(f"path 6b on the card: lookup of {sk.shape[0]} sampled keys: "
            f"{viol} keys with |pos - lb| > {line}, err {int(err.min())}..{int(err.max())}; "
            f"search with the original keys {mism} mismatches")
        if viol or mism or int(err.min()) != line or int(err.max()) != line:
            raise RuntimeError("path 6b: the cachefix bound or search is broken")
        ks = sample[:PATH6_SAMPLE]
        card_pos = lookup(bounded, ks)[0].cpu().numpy()
        with native.NativeRMI(meta_b_path) as srv:
            npos, nerr = srv.lookup(keymod.from_image(ks))
            nidx = srv.search(keymod.from_image(ks), keys_np)
        npos = npos.astype(np.int64)
        lb = torch.searchsorted(keys, ks, side="left").cpu().numpy()
        diff = card_pos - npos
        log(f"path 6b native server on {PATH6_SAMPLE} keys: {int((diff != 0).sum())} "
            f"positions differ from the card's ({int((diff == line).sum())} one line up: "
            f"a lerp within eps of a line boundary), {int((np.abs(npos - lb) > line).sum())} "
            f"bound violations, {int((nidx.astype(np.int64) != lb).sum())} search mismatches")
        if (np.any((diff != 0) & (diff != line)) or np.any(np.abs(npos - lb) > line)
                or np.any(nidx.astype(np.int64) != lb) or np.any(nerr != line)):
            raise RuntimeError("path 6b: the native server disagrees with the card")
        del pos, err, found, idx
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    log(f"path 6 launches: {json.dumps(launches)}")
    missing = [e for e in PATH6 if launches[e] <= 0]
    if missing:
        raise RuntimeError(f"path 6: kernels not launched on the path: {missing}")
    with uncounted():
        cachefix_lookup_ms("path 6b", bounded, sk)
        check_kernels(rec, launches, ("rmi_cachefix_interp",))
    return rec, launches


def top_leaf(rmi, q):
    """The leaf the index's top sends each query to."""
    return two_layer.top_assignment(get_model(rmi.top_type), rmi.device_top_params, q,
                                    rmi.norm_offset, rmi.norm_scale,
                                    rmi.branching_factor - 1, rmi.key_type)


def f64_lookup_replays(rmi, queries):
    """rmi_lookup_* for each leaf kernel with the f64 key kind on the path's
    queries (f64 images: -0.0, +-inf and NaN among them), the path's top
    row over leaf rows of that kernel made from its linear leaves (a, b):
    (a, b) itself, the cubic (0, 0, b, a), the loglinear (ln(1 + |a|),
    b / n) and the normal (a / n, 1/16, n); guess and err bit-equal to the
    plain version on the card.  These launches are not the path's."""
    a, b = rmi.device_leaf_params.unbind(1)
    n = rmi.num_rmi_rows
    z = torch.zeros_like(a)
    tables = {"linear": rmi.device_leaf_params,
              "cubic": torch.stack([z, z, b, a], 1),
              "loglinear": torch.stack([a.abs().log1p(), b / n], 1),
              "normal": torch.stack([a / n, z + 1.0 / 16, z + n], 1)}
    for leaf, w in tables.items():
        w = w.contiguous()
        args = (queries, rmi.device_top_params, w, rmi.leaf_errors, n, rmi.norm_offset,
                rmi.norm_scale)
        kw = {"top_type": rmi.top_type, "leaf_type": leaf, "key_type": rmi.key_type}
        got = eval_kernel.lookup_clamped(*args, **kw)
        want = eval_kernel.lookup_clamped_plain(*args, **kw)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        log(f"path 7 rmi_lookup_{leaf} with the f64 key kind on {queries.shape[0]} "
            f"queries: guess and err bit-equal to the plain version {same}")
        if not same:
            raise RuntimeError(f"rmi_lookup_{leaf}: f64 images decode otherwise than the "
                               f"plain version")


def path7_phase(u_keys, gen, nq, cross_n, seed, dev, p1_rows):
    """Path 7: ``cubic,linear 262144`` on path 1's keys as f64 keys
    (typed_keys): phases 3-5 (drive), the packed plan, the fused lookup's
    time beside path 1's, its entry for every leaf kernel on f64 images
    (f64_lookup_replays), the CLI on the keys written to a ``*_f64`` SOSD
    file (cli_path: RMI_SIZE, the card build's metrics, ``double`` keys,
    load_artifact, the native server with key_is_float and the compiled
    C++), the kernels replayed against their plain versions, and the
    card-vs-CPU cross-check, then the zoo's f64 row (ZOO_F64, zoo_row) on
    the same keys.  Returns the path's launches: drive's and the CLI's,
    each counted from 0."""
    spec, B, _, replayed = PATH7
    t0 = time.perf_counter()
    data = rdata.RMIDataset(typed_keys(u_keys, KeyType.F64), KeyType.F64)
    keys = data.keys
    n = keys.shape[0]
    queries = make_f64_queries(keys, nq, gen)
    torch.cuda.synchronize()
    kmin, kmax = keymod.as_float(keys[[0, -1]], KeyType.F64).tolist()
    dups = int((keys[1:] == keys[:-1]).sum())
    log(f"path 7 keys: {n} f64 keys in [{kmin!r}, {kmax!r}] ({dups} equal to the key "
        f"before) made on the card in {time.perf_counter() - t0:.2f} s")
    rmi, rec, counts = drive(PATH7, data, queries, gen)
    plan = lookup_fast.get_plan(rmi)
    if plan.kind != "packed":
        raise RuntimeError(f"path 7: plan {plan.kind}, not the packed plan")
    ref = {"metrics": (rmi.model_max_error, rmi.model_max_error_idx,
                       rmi.model_avg_log2_error),
           "lookup": lookup(rmi, queries), "leaf": top_leaf(rmi, queries)}
    args, kw = max(rec.calls["lookup_clamped"], key=lambda c: c[0][0].shape[0])
    ms = row_ms(lambda: eval_kernel.lookup_clamped(*args, **kw), 10)
    p1 = p1_rows["rmi_lookup_linear"]
    log(f"path 7 rmi_lookup_linear (f64 key kind) at {list(args[0].shape)}: {spread(ms)}; "
        f"path 1's (u64) {p1['ms']:.4f} ms, bound {p1['bound_ms']:.4f} ms")
    f64_lookup_replays(rmi, queries)
    del rmi, args, kw
    torch.cuda.empty_cache()

    for entry in _build.launches:
        _build.launches[entry] = 0
    with tempfile.TemporaryDirectory(prefix="rmi_chip_smoke_f64_") as tmp:
        t0 = time.perf_counter()
        keys_np = data.to_numpy()
        path = os.path.join(tmp, f"books_{n}_f64")
        rdata.write_sosd_file(path, keys_np)
        log(f"path 7: {n} f64 keys written to an SOSD file in "
            f"{time.perf_counter() - t0:.3f} s (the card-to-host copy included)")
        cli_path("path 7", tmp, path, "books_f64", data, keys_np, queries, gen, ref, rec)
        del keys_np
    torch.cuda.synchronize()
    cli_counts = dict(_build.launches)
    log(f"path 7 cli launches: {json.dumps(cli_counts)}")
    del ref, queries
    check_kernels(rec, counts, replayed, timed=False)
    del rec
    torch.cuda.empty_cache()
    # the zoo's f64 row on the same keys: the hier plan
    zoo_row(data, ZOO_F64, gen, nq, cross_n, seed + 1, dev)
    del data
    torch.cuda.empty_cache()
    cross_check(spec, cross_n, max(64, (B * cross_n) // n), seed, dev,
                key_type=KeyType.F64)
    return {e: counts[e] + cli_counts[e] for e in counts}


def bounded_route_before(rmi, q):
    """bounded_search of q by the route the kernel replaced: the same
    fused lookup, then the bounded search's plain version."""
    keys, n = rmi.keys, rmi.num_rmi_rows
    guess, err = lookup(rmi, q)
    lb = cachefix_kernel.bounded_lower_bound_plain(keys, q, guess, err, n,
                                                   err_iters(rmi.model_max_error))
    return torch.where(q > keys[-1], n, lb)


def median_ms(fn, runs=HIER_RUNS):
    """(median, every run) of ``runs`` single calls timed with CUDA events,
    after one untimed call."""
    t = [cuda_ms(fn, 1) for _ in range(runs)]
    return sorted(t)[runs // 2], t


def path8_phase(u_keys, gen, nq, cross_n, seed, dev):
    """Path 8: ``linear,linear 100`` on path 1's keys as u32 keys
    (typed_keys), at ~2M keys a leaf (fewer leaves for a shorter --n):
    phases 3-5 (drive), the hierarchical plan, whose search must launch
    one fused lookup and one rmi_hier_resolve, timed against
    bounded_search and torch.searchsorted on the same batch (median of
    HIER_RUNS, all exact), lookup timed, rmi_hier_resolve timed beside its
    plain version and its library call, the other kernels replayed, and
    the card-vs-CPU cross-check.  Returns drive's launches and the
    resolve's kernels row."""
    spec, B, launched_entries, replayed = PATH8
    t0 = time.perf_counter()
    data = rdata.RMIDataset(typed_keys(u_keys, KeyType.U32), KeyType.U32)
    keys = data.keys
    n = keys.shape[0]
    # B = 100 at 200M keys; a shorter run keeps the leaves' ~2M keys
    B = max(2, B * n // 200_000_000)
    queries = make_queries(keys, nq, gen, KeyType.U32)
    torch.cuda.synchronize()
    dups = int((keys[1:] == keys[:-1]).sum())
    log(f"path 8 keys: {n} u32 keys ({dups} equal to the key before) made on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    rmi, rec, counts = drive((spec, B, launched_entries, replayed), data, queries, gen)
    plan = lookup_fast.get_plan(rmi)
    log(f"path 8 plan {plan.kind}: K={plan.K}, levels "
        f"{[lv.shape[0] for lv in plan.levels or []]}, max_err {rmi.model_max_error}")
    if plan.kind != "hier":
        raise RuntimeError(f"path 8: plan {plan.kind}, not the hierarchical plan")
    got, by_search = launched(lambda: lookup_fast.fast_search(rmi, queries))
    log(f"path 8 hier search launches: {json.dumps(by_search)}")
    if by_search != {"rmi_lookup_linear": 1, "rmi_hier_resolve": 1}:
        raise RuntimeError(f"path 8: the hier search launched {by_search}, not one "
                           f"fused lookup and one rmi_hier_resolve")
    with rec:
        by_bounded = launched(lambda: bounded_search(rmi, queries))[1]
    log(f"path 8 bounded_search launches: {json.dumps(by_bounded)}")
    if by_bounded != {"rmi_lookup_linear": 1, "rmi_bounded_lower_bound": 1}:
        raise RuntimeError(f"path 8: bounded_search launched {by_bounded}, not one fused "
                           f"lookup and one rmi_bounded_lower_bound")
    # the path's own launch of bounded_search; the timed calls are not the path's
    counts["rmi_bounded_lower_bound"] = by_bounded["rmi_bounded_lower_bound"]
    with uncounted():
        hier = median_ms(lambda: lookup_fast.fast_search(rmi, queries))
        bounded = median_ms(lambda: bounded_search(rmi, queries))
        library = median_ms(lambda: torch.searchsorted(keys, queries))
        before = median_ms(lambda: bounded_route_before(rmi, queries), 3)
        mism = (mismatches(keys, queries, got),
                mismatches(keys, queries, bounded_search(rmi, queries)),
                mismatches(keys, queries, bounded_route_before(rmi, queries)))
    del got
    look = row_ms(lambda: lookup(rmi, queries), 10)
    log(f"path 8 search of {nq} queries, median of {HIER_RUNS} (CUDA events): hier "
        f"{hier[0]:.4f} ms {[round(x, 4) for x in hier[1]]}, bounded_search "
        f"{bounded[0]:.4f} ms {[round(x, 4) for x in bounded[1]]} (the route it "
        f"replaced, the bounded search's plain version: {before[0]:.4f} ms "
        f"{[round(x, 4) for x in before[1]]}), torch.searchsorted "
        f"{library[0]:.4f} ms {[round(x, 4) for x in library[1]]}; mismatches {mism}; "
        f"lookup {spread(look)}")
    log("path 8 search " + json.dumps({"hier_ms": hier[0], "bounded_ms": bounded[0],
                                       "bounded_before_ms": before[0],
                                       "searchsorted_ms": library[0], "lookup_ms": look[0],
                                       "mismatches": list(mism)}))
    if any(mism):
        raise RuntimeError("path 8: hier or bounded search disagrees with "
                           "torch.searchsorted")
    del rmi
    with uncounted():
        rows = check_kernels(rec, counts, ("rmi_hier_resolve", "rmi_bounded_lower_bound"))
        log("path 8 rmi_aug_fit_moments, leaves of ~2M keys " + json.dumps(
            check_kernels(rec, counts, ("rmi_aug_fit_moments",))["rmi_aug_fit_moments"]))
        check_kernels(rec, counts, tuple(e for e in replayed if e not in (
            "rmi_hier_resolve", "rmi_aug_fit_moments")), timed=False)
    del rec, data, queries
    torch.cuda.empty_cache()
    cross_check(spec, cross_n, max(64, (B * cross_n) // n), seed, dev,
                key_type=KeyType.U32)
    return counts, rows


# path 9: the optimizer.  9a is the reference's max_size_wiki CI config
# (tests/test_sosd.py), on SOSD_SYNTH.json's keys (tools/run_sosd_synth.py:
# seed 7); its TPU row (df64 on the TPU, no gate) is logged beside the port's
MAX_SIZE = 50_000_000
WIKI_SEED = 7
SOSD_SYNTH_WIKI = {"models": "linear,linear", "branching_factor": 1048576,
                   "size_bytes": 25165840, "avg_log2": 4.322036503821778,
                   "max_err": 200000003, "build_s": 2567.814}
# 9c: the default profile's 21 pairs over three branching factors
PATH9C_BFS = [1 << 6, 1 << 10, 1 << 14]
# 9d: the disk profile's most memory-hungry point
PATH9D = ("robust_linear,cubic", 1 << 27)
PATH9_CHUNK = 1 << 22         # keys a step of 9a's bound check over every key
# what path 9 launches: its sweeps' builds (linear and cubic leaves;
# FixDups in each dataset's shared inputs) and 9a's bound check (the fused lookup of
# its chosen leaves); 9a's search logs the entries it launched
PATH9 = ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", "rmi_sweep_max_cubic",
         RUN_MAX, "rmi_leaf_eval_linear", "rmi_leaf_eval_cubic", "rmi_cubic_l1")


def leaf_path(leaf_type):
    """The entries a build over ``leaf_type`` leaves (linear or cubic, the
    optimizer's leaves) and its fused lookup launch: what path 9 replays
    from 9a's final build and from 9d's build, each with its lookups."""
    k = get_model(leaf_type).leaf_kernel
    return ("rmi_fixdups", "rmi_cubic_l1" if k == "cubic" else "rmi_aug_fit_moments",
            f"rmi_sweep_max_{k}", RUN_MAX, f"rmi_leaf_eval_{k}", f"rmi_lookup_{k}")


@contextlib.contextmanager
def uncounted():
    """Launches made inside (a replay against the plain versions, a
    card-vs-CPU cross-check) left out of the path's counts."""
    saved = dict(_build.launches)
    try:
        yield
    finally:
        _build.launches.update(saved)


def legacy_calls(rec):
    """Record the K1 call that the build made before rmi_fixdups, from the
    path's recorded calls of that: the running max over where(changed, i,
    0) of its FixDups keys (uncounted).  The data-parallel build's K1
    calls take its [world]-element carries alone, so K1's row is timed on
    the main path's [n] input."""
    with uncounted():
        for (keys,), _ in rec.calls["fixdups"]:
            n = keys.shape[0]
            changed = torch.ones(n, dtype=torch.bool, device=keys.device)
            torch.ne(keys[1:], keys[:-1], out=changed[1:])
            v = torch.where(changed, torch.arange(n, dtype=torch.int32, device=keys.device), 0)
            rec.calls["scan_i32"].append(((v,), {"is_max": True, "fill": seg.INT32_MIN}))


def max_leaf(rmi):
    """Where a build's max error lies: its leaf, the keys the top routes
    there, whether it is the final leaf and whether it is empty, the
    final leaf's keys and error, and the errors of the leaves around it."""
    B, L = rmi.branching_factor, rmi.model_max_error_idx
    counts = torch.bincount(top_leaf(rmi, rmi.keys).long(), minlength=B)
    return {"max_err": rmi.model_max_error, "leaf": L, "keys_routed": int(counts[L]),
            "final_leaf": L == B - 1, "empty": int(counts[L]) == 0,
            "final_leaf_keys": int(counts[B - 1]),
            "final_leaf_err": int(rmi.leaf_errors[B - 1]),
            "errors_around": rmi.leaf_errors[max(L - 2, 0):L + 3].tolist()}


def max_error_leaf(rmi):
    """max_leaf's facts as a line of the log."""
    w, B = max_leaf(rmi), rmi.branching_factor
    return (f"max error {w['max_err']} at leaf {w['leaf']} of {B} ({w['keys_routed']} keys "
            f"routed there; the final leaf {w['final_leaf_keys']}; leaves "
            f"{max(w['leaf'] - 2, 0)}.. err {w['errors_around']})")


@contextlib.contextmanager
def environ(**values):
    """os.environ with ``values`` set (None: unset), restored on exit."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_lines(label):
    """The optimizer's two phases as profiling.phase timed them in the run
    just made: builds, wall seconds, and each build's device ms (CUDA
    events around its dispatch)."""
    for name in ("phase1", "phase2"):
        if name not in profiling.last_phase_builds:
            raise RuntimeError(f"{label}: the optimizer did not time its {name}")
        p, wall = profiling.last_phase_builds[name], profiling.last_phase_times[name]
        ms = sorted(p["device_ms"])
        if len(ms) != p["builds"] or not ms:
            raise RuntimeError(f"{label}: {name} timed {len(ms)} of {p['builds']} builds")
        log(f"{label} {name}: {p['builds']} builds, {wall:.3f} s wall, "
            f"{wall / p['builds']:.4f} s a build; device ms a build (CUDA events around "
            f"each dispatch) median {ms[len(ms) // 2]:.3f}, min {ms[0]:.3f}, max "
            f"{ms[-1]:.3f}")


def clear_phase_times():
    profiling.last_phase_times.clear()
    profiling.last_phase_builds.clear()


def count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): its result, the
    count of synchronizing calls and the line of this repo that made each
    (the innermost frame under the port or this script when the warning
    reaches Python: a warning raised where torch has no Python handler,
    as in the kernels' binding, surfaces at the next torch call)."""
    here = os.path.dirname(os.path.abspath(__file__))
    where = []

    def seen(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if os.path.abspath(f.filename).startswith(here)]
        f = frames[-1] if frames else None
        where.append(f"{os.path.relpath(f.filename, here)}:{f.lineno}" if f else filename)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, len(where), sorted(set(where))


def build_syncs(data):
    """Path 1's build under the sync debug mode: the synchronizing calls of
    one dispatch with and without the shared inputs, and of its fetch; then
    its three stages under RMI_PROFILE_BUILD=1."""
    spec, B = PATH1[0], PATH1[1]
    shared = two_layer.shared_inputs(data.keys, data.key_type)
    torch.cuda.synchronize()
    for label, sh in (("with the shared inputs", shared), ("without them", None)):
        pending, count, where = count_syncs(
            lambda: train_api.train_async(data, spec, B, shared=sh))
        _, fetch, fetch_where = count_syncs(pending.result)
        log(f"path 9 host syncs of one {spec} {B} build {label}: {count} in the "
            f"dispatch at {where}, {fetch} in the fetch at {fetch_where}")
        del pending
    del shared
    with environ(RMI_PROFILE_BUILD="1"):
        profiling.last_phase_times.clear()
        rmi_tpu_torch.train(data, spec, B)
    log("path 9 RMI_PROFILE_BUILD=1, " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in profiling.last_phase_times.items())
        + f" (host clock, each stage ending in a synchronize)")
    torch.cuda.empty_cache()


def sosd_file(files, kind, n):
    """The SOSD file of n ``kind`` keys (synthetic_dataset, seed
    WIKI_SEED, as tools/run_sosd_synth.py makes SOSD_SYNTH.json's) in the
    directory files["dir"], named as tests/test_sosd.py:40-41 names it;
    made on the host and written on first use, then shared (paths 9a and
    11).  Logs the first and last key and the duplicates."""
    if kind not in files:
        t0 = time.perf_counter()
        keys_np = rdata.synthetic_dataset(kind, n, KeyType.U64, seed=WIKI_SEED)
        name = SOSD_NAMES[kind].replace("200M", "200M" if n == 200_000_000 else str(n))
        files[kind] = os.path.join(files["dir"], name)
        rdata.write_sosd_file(files[kind], keys_np)
        dups = int(np.count_nonzero(keys_np[1:] == keys_np[:-1]))
        log(f"{kind} keys: {n} (seed {WIKI_SEED}) made on the host and written to {name} in "
            f"{time.perf_counter() - t0:.3f} s; first {int(keys_np[0])}, last "
            f"{int(keys_np[-1])}, {dups} equal to the key before")
    return files[kind]


def max_size_wiki(tmp, path, n, gen):
    """9a: ``--max-size 50000000`` on the wiki keys of the SOSD file
    ``path`` under the fast profile, through the CLI: the chosen
    configuration beside SOSD_SYNTH.json's TPU row, RMI_SIZE < MAX_SIZE, 0
    bound violations over every key of the artifact loaded back onto the
    card, 0 search mismatches on 2^22 queries, the phases' builds and
    times, the CLI's time split."""
    clear_phase_times()
    with environ(RMI_OPTIMIZER_PROFILE="fast"):
        total, t = run_cli(tmp, [path, "wiki", "--max-size", str(MAX_SIZE),
                                 "--stats-file", "stats_wiki.json"], {
            "load": (rmi_tpu_torch, "load_data"),
            "sweep": (optimizer, "find_pareto_efficient_configs"),
            "final train": (train_api, "train"),
            "artifact": (rmi_tpu_torch, "output_rmi")})
    stats = json.load(open(os.path.join(tmp, "stats_wiki.json")))
    meta_path = os.path.join(tmp, "rmi_data", "wiki.json")
    size = stats["size binary search"]
    ref = SOSD_SYNTH_WIKI
    log(f"path 9a max_size_wiki: chose {stats['layers']} {stats['branching factor']}, "
        f"max_err {stats['max error']}, avg_log2 {stats['average log2 error']!r}, "
        f"RMI_SIZE {size} (< {MAX_SIZE}); SOSD_SYNTH.json's TPU row (rmi_tpu, df64, "
        f"no gate): {ref['models']} {ref['branching_factor']}, max_err {ref['max_err']}, "
        f"avg_log2 {ref['avg_log2']!r}, RMI_SIZE {ref['size_bytes']}, {ref['build_s']} s "
        f"on the TPU")
    phase_lines("path 9a")
    log(f"path 9a cli: {total:.3f} s ({t.line()})")
    del t
    if not size < MAX_SIZE or json.load(open(meta_path))["rmi_size"] != size:
        raise RuntimeError(f"path 9a: RMI_SIZE {size} is not under {MAX_SIZE}")

    data = rmi_tpu_torch.load_data(path)
    keys = data.keys
    spec, B = stats["layers"], stats["branching factor"]
    loaded = rmi_tpu_torch.load_artifact(meta_path, keys=keys)
    viol = 0
    with Recorder() as rec:
        # the CLI's final build again, its kernel calls recorded
        rmi = rmi_tpu_torch.train(data, spec, B)
        for i in range(0, n, PATH9_CHUNK):
            k = keys[i:i + PATH9_CHUNK]
            g, e = lookup(loaded, k)
            viol += int(((g - torch.searchsorted(keys, k, side="left")).abs() > e).sum())
    got = (rmi.model_max_error, rmi.model_avg_log2_error, rmi_size(rmi))
    want = (stats["max error"], stats["average log2 error"], size)
    log(f"path 9a {spec} {B} built again on the card: max_err, avg_log2, RMI_SIZE {got} "
        f"(the CLI's {want}); {max_error_leaf(rmi)}")
    if got != want:
        raise RuntimeError("path 9a: the same keys gave another build than the CLI's")
    del rmi
    q = make_queries(keys, min(1 << 22, n), gen)
    before = dict(_build.launches)
    got = search(loaded, q)
    torch.cuda.synchronize()
    route = {e: c - before[e] for e, c in _build.launches.items() if c != before[e]}
    mism = mismatches(keys, q, got)
    log(f"path 9a artifact on the card: {viol} bound violations over all {n} keys "
        f"({PATH9_CHUNK} a lookup), search {mism} mismatches on {q.shape[0]} queries "
        f"(plan {lookup_fast.get_plan(loaded).kind}, launches {json.dumps(route)})")
    if viol or mism:
        raise RuntimeError("path 9a: the bound or search is broken")
    leaf = loaded.leaf_type
    del loaded, data, keys, q, g, e, k, got
    torch.cuda.empty_cache()
    with uncounted():
        check_kernels(rec, {}, leaf_path(leaf), timed=False)
    del rec
    torch.cuda.empty_cache()
    return get_model(leaf).leaf_kernel


def optimize_books(tmp, data):
    """9b: ``--optimize front.json`` under the default profile on path 1's
    keys written to an SOSD file, then ``--param-grid front.json``, which
    builds every configuration of the front as an artifact: each one's
    RMI_SIZE and avg_log2 equal to the front's."""
    n = data.n
    t0 = time.perf_counter()
    path = os.path.join(tmp, f"books_{n}_uint64")
    rdata.write_sosd_file(path, data.to_numpy())
    log(f"path 9b: {n} keys written to an SOSD file in {time.perf_counter() - t0:.3f} s")
    clear_phase_times()
    with environ(RMI_OPTIMIZER_PROFILE=None):
        total, t = run_cli(tmp, [path, "--optimize", "front.json"], {
            "load": (rmi_tpu_torch, "load_data"),
            "sweep": (optimizer, "find_pareto_efficient_configs")})
    phase_lines("path 9b")
    log(f"path 9b --optimize: {total:.3f} s ({t.line()})")
    front = json.load(open(os.path.join(tmp, "front.json")))["configs"]
    total, t = run_cli(tmp, [path, "--param-grid", "front.json"], {
        "load": (rmi_tpu_torch, "load_data"),
        "builds (one fetch)": (sweep, "parallel_train_grid"),
        "artifacts": (rmi_tpu_torch, "output_rmi")})
    log(f"path 9b --param-grid front.json: {len(front)} artifacts in {total:.3f} s "
        f"({t.line()})")
    del t
    results = json.load(open(os.path.join(tmp, "front.json_results")))["results"]
    bad = []
    for c, r in zip(front, results):
        meta = json.load(open(os.path.join(tmp, "rmi_data", f"{c['namespace']}.json")))
        got = (r["layers"], r["branching factor"], r["size binary search"], meta["rmi_size"],
               r["average log2 error"])
        want = (c["layers"], c["branching factor"], c["size"], c["size"],
                c["average log2 error"])
        if got != want:
            bad.append((got, want))
    if bad or len(results) != len(front) or not front:
        raise RuntimeError(f"path 9b: the param grid's artifacts differ from the front: "
                           f"{bad}")
    log(f"path 9b: each of the {len(front)} artifacts' RMI_SIZE and avg_log2 equal the "
        f"front's")


def same_max_log2(a, b):
    """Two max log2 errors of one max error: the card's log2 and the CPU's
    may round its last bit otherwise (log2(120))."""
    return round(2.0 ** a) == round(2.0 ** b) and abs(a - b) <= math.ulp(b)


def front_card_vs_cpu(n, seed, dev):
    """9c: the optimizer on the card and on the CPU over PATH9C_BFS on n
    books-like keys: the same (models, B, size) list, the same max errors
    (their log2 within an ulp: same_max_log2) and each avg_log2 within
    METRIC_RTOL relative."""
    keys = rdata.books_like_on_device(n, seed, dev)
    fronts, secs = [], []
    saved = optimizer.branching_factors
    optimizer.branching_factors = lambda: list(PATH9C_BFS)
    try:
        with environ(RMI_OPTIMIZER_PROFILE=None):
            for k in (keys, keys.cpu()):
                t0 = time.perf_counter()
                fronts.append(optimizer.find_pareto_efficient_configs(
                    rdata.RMIDataset(k, KeyType.U64)))
                secs.append(time.perf_counter() - t0)
    finally:
        optimizer.branching_factors = saved
    card, cpu = fronts
    rows = [[(s.models, s.branching_factor, s.size) for s in f] for f in fronts]
    log(f"path 9c front at n={n}, branching factors {PATH9C_BFS}: card {secs[0]:.3f} s, "
        f"CPU {secs[1]:.3f} s\n{optimizer.display_table(card)}")
    if rows[0] != rows[1]:
        raise RuntimeError(f"path 9c: the card's front {rows[0]} is not the CPU's {rows[1]}")
    gaps = [abs(a.average_log2_error - b.average_log2_error) / abs(b.average_log2_error)
            for a, b in zip(card, cpu)]
    same_max = [same_max_log2(a.max_log2_error, b.max_log2_error) for a, b in zip(card, cpu)]
    log(f"path 9c: card and CPU fronts equal; max log2 errors bit-equal "
        f"{[a.max_log2_error == b.max_log2_error for a, b in zip(card, cpu)]}, within an "
        f"ulp of one max error {same_max}; avg_log2 relative gaps {gaps} (limit "
        f"{METRIC_RTOL})")
    if not all(same_max) or max(gaps) > METRIC_RTOL:
        raise RuntimeError("path 9c: the card's front measures otherwise than the CPU's")


def largest_disk_point(data, gen, nq, cross_n, seed, dev):
    """9d: the disk profile's most memory-hungry point at the paths' keys:
    its wall time and peak device memory; then built again with its kernel
    calls recorded (bit-equal leaf errors and metrics), the bound on nq
    sampled keys, where its max error lies, its kernels replayed against
    their plain versions at these shapes, and its card-vs-CPU cross-check
    at cross_n keys with as many leaves a key."""
    spec, B = PATH9D
    n = data.n
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rmi = rmi_tpu_torch.train(data, spec, B)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    first = (rmi.model_max_error, rmi.model_max_error_idx, rmi.model_avg_log2_error)
    errors = rmi.leaf_errors.cpu()
    log(f"path 9d {spec} {B} at {n} keys: build {secs:.4f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; "
        f"max_err {rmi.model_max_error}, avg_log2 {rmi.model_avg_log2_error!r}, RMI_SIZE "
        f"{rmi_size(rmi)}")
    del rmi
    torch.cuda.empty_cache()
    with Recorder() as rec:
        rmi = rmi_tpu_torch.train(data, spec, B)
        viol = bound_violations(rmi, data.keys, nq, gen)
    again = (first == (rmi.model_max_error, rmi.model_max_error_idx,
                       rmi.model_avg_log2_error)
             and torch.equal(rmi.leaf_errors.cpu(), errors))
    log(f"path 9d built again, its kernel calls recorded: bit-equal {again}; "
        f"{max_error_leaf(rmi)}; {viol} bound violations on {nq} sampled keys")
    if viol or not again or not math.isfinite(rmi.model_avg_log2_error):
        raise RuntimeError("path 9d: the bound is broken or the build not reproducible")
    del rmi, errors
    torch.cuda.empty_cache()
    with uncounted():
        check_kernels(rec, {}, leaf_path("cubic"), timed=False)
        del rec
        torch.cuda.empty_cache()
        cross_check(spec, cross_n, max(64, (B * cross_n) // n), seed, dev, sparse=True)


def optimizer_phase(data, gen, nq, cross_n, seed, dev, files):
    """Path 9, the launches counted from 0: the host syncs of one build,
    9a max_size_wiki (on sosd_file(files, "wiki", n)), 9b --optimize and
    --param-grid on the paths' keys, 9d
    the largest disk-profile point (9a's final build and 9d's build
    replayed against the plain versions, uncounted), then 9c the front on
    the card against the CPU.  Returns the launches."""
    for entry in _build.launches:
        _build.launches[entry] = 0
    build_syncs(data)
    wiki = sosd_file(files, "wiki", data.n)
    with tempfile.TemporaryDirectory(prefix="rmi_chip_smoke_wiki_") as tmp:
        kernel = max_size_wiki(tmp, wiki, data.n, gen)
    with tempfile.TemporaryDirectory(prefix="rmi_chip_smoke_front_") as tmp:
        optimize_books(tmp, data)
    torch.cuda.empty_cache()
    largest_disk_point(data, gen, nq, cross_n, seed + 1, dev)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    log(f"path 9 launches: {json.dumps(launches)}")
    missing = [e for e in (*PATH9, f"rmi_lookup_{kernel}") if launches[e] <= 0]
    if missing:
        raise RuntimeError(f"path 9: kernels not launched on the path: {missing}")
    front_card_vs_cpu(cross_n, seed, dev)
    return launches


# path 10: the data-parallel build and sharded serving (rmi_tpu_torch/parallel/)
# on path 1's keys, by ranks that share card 0: 10a four gloo ranks, 10b one
# NCCL rank (path 1's spec); 10c robust_linear,cubic on the card against the
# CPU; 10d the per-device copies in this process
# what 10a launches over its ranks: the dp build (its per-shard forms:
# FixDups with its carry, the cubic top's partial L1 sums, the leaf fits'
# clip sums, the counted runs; K1 on the carries, stage A's normalization
# and assignment, K2, K2 xx and K2 weighted on the targets, K3, K4 per
# element) and the bound check (K4's fused lookup); each rank's 2^20 queries
# fall below search's density gate at 200M keys (4 nq < 3 ceil(n / 64),
# lookup_fast.sorts), so they take the packed plan, in torch; 10d serves
# twice as many queries over two copies, 2^22 a copy, past the gate: K5's
# scatter entry
DP_FORMS = ("rmi_fixdups_carry", "rmi_top_l1_partial", "rmi_aug_fit_sums",
            "rmi_span_run_max_carry")
PATH10 = ("cubic,linear", 262144,
          (*DP_FORMS, "rmi_scan_i32", "rmi_key_normalize", "rmi_top_assign",
           "rmi_aug_moments", "rmi_aug_moments_xx", "rmi_aug_moments_weighted",
           "rmi_sweep_max_linear", "rmi_leaf_eval_linear", "rmi_lookup_linear"))
# the rows 10b times on its one rank's calls (the shard is all of path 1's
# keys): the dp forms and K2's three entries, whose callers they are
DP_TIMED = (*DP_FORMS, "rmi_aug_moments", "rmi_aug_moments_xx", "rmi_aug_moments_weighted")
# the dp builds of path 4's and path 3's specs, a rank: their normal and
# loglinear leaves are the callers of K2 xx and K2 weighted (their sums
# cross ranks); 10b logs each one's warm build and peak memory
PATH10_XX = ("cubic,normal", 65536)
PATH10_W = ("cubic,loglinear", 65536)
PATH10D = ("rmi_serve_sorted_scatter",)
PATH10_RANKS = 4
PATH10_WARM = 3               # warm dp builds timed a run; the median is logged
PATH10_SERVES = 3             # timed runs of the sharded search
PATH10C = ("robust_linear,cubic", 4096)
PATH10_TIMEOUT = 900
DP_ROWS_RTOL, DP_ROWS_ATOL, DP_LOG2_RTOL = 1e-6, 1e-8, 1e-6   # tests/test_parallel.py:52-63
# at 200M keys a leaf's line spans ~4e-6 of the normalized domain, so its
# intercept cancels (alpha = mean_y - beta mean_x, |alpha| << mean_y) and
# the order of the sums moves it by more than 1e-6 relative; such a leaf
# passes, on at most B/20 leaves, if its two rows put each of its keys
# within half a position of each other (a floor then moves by at most 1,
# which the error tolerance allows), floor its two epsilon probes at most
# 1 apart, and the dp row is within half a position of the leaf's exact
# least-squares line (_exact_slr) at those keys and at those probes as the
# build takes them, clamped to [0, n] (two_layer.final_errors; a probe
# past the last key lies far outside the domain), or no farther from it
# than path 1's row
DP_PRED_GAP = 0.5


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _same_dp(a, b):
    """Two dp builds' outputs (host or device) bit-equal."""
    def eq(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[k], y[k]) for k in x)
        if torch.is_tensor(x):
            return torch.equal(x, y)
        return np.array_equal(x, y)
    return all(eq(x, y) for x, y in zip(a[:3], b[:3])) and a[3] == b[3]


def dp_rank(rank, sosd_path, spec, B, nq, qseed, device, serve_queries, check):
    """One rank of path 10a (10b: without serving): the shard of the SOSD
    file's keys, loaded whole onto ``device``; a cold and PATH10_WARM warm
    dp builds (the first two bit-equal), one more with the time in
    collectives clocked, the peak device memory over them; a cold and a
    warm dp build each of PATH10_XX and PATH10_W (K2 xx's and K2
    weighted's callers), the warm one timed with its peak; then one build
    each of the three specs recorded (rank 0); the bound |guess - yfix| <=
    err on every key of the shard; then, with ``serve_queries``, rank 0's
    index replicated to every rank and nq queries (the same on every rank,
    from ``qseed``) served sharded, timed; the launches counted from the
    first build to the last search.  ``check`` "replay": the recorded calls
    of PATH10's entries replayed against their plain versions on rank 0
    (uncounted); "time": DP_TIMED's rows timed on them, each of their calls
    replayed on the card; "both": the two."""
    from rmi_tpu_torch.parallel import dp_trainer, serve
    import torch.distributed as dist
    dev = torch.device(device)
    top, leaf = spec.split(",")
    data = rdata.load_data(sosd_path, device=dev)
    keys_local, n = dp_trainer.local_shard(data.keys, data.key_type)
    comm = dp_trainer.DPGroup()
    out = {"rank": rank, "world": comm.world}
    for entry in _build.launches:
        _build.launches[entry] = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    check = check if rank == 0 else None
    rec = Recorder() if check else contextlib.nullcontext()

    def build(spec_b, B_b, group=comm):
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        res = dp_trainer.dp_train_two_layer(keys_local, n, data.key_type,
                                            *spec_b.split(","), B_b, group)
        _sync(dev)
        return res, time.perf_counter() - t0

    walls, builds = [], []
    for i in range(1 + PATH10_WARM):
        res, wall = build(spec, B)
        walls.append(wall)
        builds.append(res if i < 2 else None)
    out["same_build"] = _same_dp(builds[0], builds[1])
    res = builds[0]
    del builds
    timed = dp_trainer.DPGroup(timed=True)
    out["timed_build_s"] = build(spec, B, timed)[1]
    out["collective_s"], out["collectives"] = timed.seconds, timed.calls
    out["walls"] = walls
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                       if dev.type == "cuda" else None)
    out["specs"] = {}
    for spec_b, B_b in (PATH10_XX, PATH10_W):
        build(spec_b, B_b)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        out["specs"][f"{spec_b} {B_b}"] = (build(spec_b, B_b)[1], (
            torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None))
    with rec:
        for spec_b, B_b in ((spec, B), PATH10_XX, PATH10_W):
            build(spec_b, B_b)

    # the bound on every key of the shard, against the build's own FixDups
    rmi = dp_trainer.trained_rmi(data.keys, data.key_type, top, leaf, B, res)
    yfix = dp_trainer.dist_fixdups(keys_local, comm)
    real = max(0, min(keys_local.shape[0], n - rank * keys_local.shape[0]))
    with rec:
        guess, err = lookup(rmi, keys_local[:real])
    out["violations"] = int(((guess - yfix[:real].long()).abs() > err).sum())
    out["checked_keys"] = real
    del guess, err, yfix
    if serve_queries:
        replica = serve.replicate_rmi(rmi if rank == 0 else None, device=dev)
        out["replica_equal"] = same_build(replica, rmi)
        del rmi
        gen = torch.Generator(device=dev)
        gen.manual_seed(qseed)
        queries = make_queries(data.keys, nq, gen)
        part, m = serve.shard_queries(queries)
        with rec:
            answers = serve.unshard(search(replica, part), m)
        out["mismatches"] = mismatches(data.keys, queries, answers)
        times, alone = [], []
        for _ in range(PATH10_SERVES):
            _sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            got = search(replica, part)
            _sync(dev)
            alone.append(time.perf_counter() - t0)
            serve.unshard(got, m)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        out["serve_s"], out["search_alone_s"] = sorted(times), sorted(alone)
        out["part"] = part.shape[0]
        out["route"] = search_route(replica, part.shape[0])
    _sync(dev)
    out["launches"] = dict(_build.launches)
    out["res"] = res
    if check:
        data = res = rmi = None         # the recorded calls alone stay on the card
        replays = {}
        with uncounted():
            if check != "time":
                replays.update(check_kernels(rec, {}, PATH10[2], timed=False))
            if check != "replay":
                out["rows"] = check_kernels(rec, out["launches"], DP_TIMED)
                replays.update(out["rows"])
        out["replays"] = {e: r["max_abs_err"] for e, r in replays.items()}
    return out


def dp_cross_rank(rank, keys_np, spec, B, device):
    """One rank of 10c: the dp build of ``keys_np`` on ``device``, with the
    top's leaf ids and each leaf's key count, and the launches."""
    from rmi_tpu_torch.parallel import dp_trainer
    data = rdata.RMIDataset.from_numpy(keys_np, device=device)
    keys_local, n = dp_trainer.local_shard(data.keys, data.key_type)
    for entry in _build.launches:
        _build.launches[entry] = 0
    top, leaf = spec.split(",")
    res = dp_trainer.dp_train_two_layer(keys_local, n, data.key_type, top, leaf, B)
    rmi = dp_trainer.trained_rmi(data.keys, data.key_type, top, leaf, B, res)
    t = two_layer.top_assignment(get_model(top), rmi.device_top_params, data.keys,
                                 rmi.norm_offset, rmi.norm_scale, B - 1)
    spans = seg.make_spans(t, B)
    return {"res": res, "t": t, "counts": spans.ends - spans.starts,
            "launches": dict(_build.launches)}


def _explained(counts, e1, e2):
    """The avg_log2 share of the leaves whose errors differ."""
    d = np.abs(np.log2(2.0 * e1 + 2.0) - np.log2(2.0 * e2 + 2.0))
    return float((counts * d).sum()) / float(counts.sum())


def dp_tolerance(label, res, want, data):
    """rmi_tpu's dp tolerance (tests/test_parallel.py:52-63) of a dp
    build's outputs against ``want`` (path1_host: a single-card build's
    host copies) over ``data``'s keys: leaf errors within 1 on at most
    B/20 leaves, leaf rows within rtol 1e-6 and atol 1e-8, avg_log2
    within 1e-6 relative plus what the leaves whose errors differ
    explain; a leaf whose rows fall outside passes as DP_PRED_GAP says,
    on at most B/20 leaves.  Those leaves are logged with their key
    counts, the gaps and each row's distance from the exact line."""
    top_w, leaf_w, errs, metrics = res
    e1, e2 = want["leaf_errors"].astype(np.int64), np.asarray(errs).astype(np.int64)
    B = e1.shape[0]
    differ = int((e1 != e2).sum())
    leaf_w = np.asarray(leaf_w)
    rows_gap = np.abs(leaf_w - want["leaf_w"])
    outside = (rows_gap > DP_ROWS_ATOL + DP_ROWS_RTOL * np.abs(want["leaf_w"])).any(1)
    d_log2 = abs(metrics["model_avg_log2_error"] - want["avg_log2"])
    explained = _explained(want["counts"], e1, e2)
    got = {"top_rows_equal": bool(np.array_equal(np.asarray(top_w), want["top_w"])),
           "leaf_errors_differing": differ, "leaf_errors_max_diff": int(np.abs(e1 - e2).max()),
           "leaf_rows_outside": int(outside.sum()), "leaf_rows_max_abs_gap": float(rows_gap.max()),
           "max_err": metrics["model_max_error"], "avg_log2": metrics["model_avg_log2_error"],
           "avg_log2_abs_diff": d_log2, "explained_by_differing_leaves": explained}
    rows_ok = int(outside.sum()) <= max(1, B // 20)
    if outside.any() and rows_ok:
        cnt = want["counts"][outside]
        got["outside_keys_a_leaf"] = [int(cnt.min()), int(np.median(cnt)), int(cnt.max())]
        wit = _outside_witness(data, want, leaf_w, outside)
        got.update({k: v for k, v in wit.items() if k != "ok"})
        rows_ok = wit["ok"]
    log(f"{label} against path 1's index: {json.dumps(got)}")
    if not (got["leaf_errors_max_diff"] <= 1 and differ <= max(1, B // 20) and rows_ok
            and d_log2 <= DP_LOG2_RTOL * abs(want["avg_log2"]) + explained):
        raise RuntimeError(f"{label}: the dp build and path 1's disagree beyond tolerance")


def _exact_slr(x, y):
    """(alpha, beta) of the least-squares line through the f64 points x
    and integer targets y, in exact rational arithmetic, with the f64
    fit's degenerate cases (models/linear._slr_from_moments): a witness
    independent of any order of summation."""
    cnt = len(x)
    if cnt == 0:
        return Fraction(0), Fraction(0)
    xs = [Fraction(v) for v in x.tolist()]
    ys = y.tolist()
    sx, sy = sum(xs), sum(ys)
    sxx = sum(v * v for v in xs) - sx * sx / cnt
    sxy = sum(v * w for v, w in zip(xs, ys)) - sx * sy / cnt
    mean_y = Fraction(sy, cnt)
    if cnt == 1 or sxx <= 0:
        return mean_y, Fraction(0)
    beta = sxy / sxx
    return mean_y - beta * sx / cnt, beta


def _outside_witness(data, want, leaf_w, leaves):
    """The leaves of ``leaves`` (a [B] mask; linear leaves) whose dp and
    path 1 rows fall outside rtol, each held to its exact least-squares
    line over its augmented span (_exact_slr on the host): the largest
    gap between the two rows' predictions at the keys path 1's top routes
    to each leaf and at its two epsilon probes (two_layer.final_errors),
    the largest gap between their floors at the probes, each row's
    largest distance from the exact line's prediction at the keys and at
    the probes (both clamped to [0, n] there, as the build takes a
    probe's prediction), its slope's relative error, and the leaf
    farthest from the exact line; ``ok`` when every leaf passes as
    DP_PRED_GAP says."""
    if want["leaf_type"] != "linear":
        raise NotImplementedError("the exact witness fits linear leaves")
    dev, kt, n = data.keys.device, data.key_type, data.n
    mleaf = get_model("linear")
    ids = np.flatnonzero(leaves)
    a0, a1 = want["aug"][0][ids], want["aug"][1][ids]
    s0, s1 = want["starts"][ids], want["ends"][ids]
    aug_idx = torch.from_numpy(np.concatenate([np.arange(a, b) for a, b in zip(a0, a1)]))
    with uncounted():
        x = model_float_input(mleaf, data.keys[aug_idx.to(dev)], *want["norm"], kt)
        y = two_layer.fixdups_i32(data.keys)[aug_idx.to(dev)]
        nxt, prv = (torch.from_numpy(want["probes"][i][ids]).to(dev) for i in (0, 1))
        xp = model_float_input(mleaf, torch.cat([keymod.minus_epsilon(nxt, kt),
                                                 keymod.plus_epsilon(prv, kt)]),
                               *want["norm"], kt)
        lid = torch.from_numpy(np.repeat(ids, a1 - a0)).to(dev)
        pid = torch.from_numpy(np.concatenate([ids, ids])).to(dev)
        pred = {}
        for name, w in (("dp", leaf_w), ("p1", want["leaf_w"])):
            w = torch.from_numpy(np.ascontiguousarray(w)).to(dev)
            at_keys = leaf_predict("linear", w, lid, kernel_input(mleaf, x))
            at_probes = leaf_predict("linear", w, pid, kernel_input(mleaf, xp))
            pred[name] = (at_keys.cpu().numpy(), at_probes.cpu().numpy(),
                          predict_clamped(at_probes, n).cpu().numpy())
    x, y, xp = x.cpu().numpy(), y.cpu().numpy().astype(np.int64), xp.cpu().numpy()
    k = len(ids)
    st = {key: np.zeros(k) for key in ("keys", "probes", "floors", "distinct", "beta")
          + tuple(f"{what}_{b}" for what in ("at_keys", "at_probes", "slope")
                  for b in ("dp", "p1"))}
    lo = 0
    for j in range(k):
        m = a1[j] - a0[j]
        alpha, beta = _exact_slr(x[lo:lo + m], y[lo:lo + m])
        on = slice(lo + s0[j] - a0[j], lo + s1[j] - a0[j])      # the leaf's own keys
        probes = xp[[j, k + j]]
        st["keys"][j] = np.abs(pred["dp"][0][on] - pred["p1"][0][on]).max(initial=0.0)
        st["probes"][j] = np.abs(pred["dp"][1][[j, k + j]] - pred["p1"][1][[j, k + j]]).max()
        st["floors"][j] = np.abs(pred["dp"][2][[j, k + j]] - pred["p1"][2][[j, k + j]]).max()
        st["distinct"][j] = np.unique(x[lo:lo + m]).shape[0]
        st["beta"][j] = float(beta)
        for b, w in (("dp", leaf_w), ("p1", want["leaf_w"])):
            for where, pts, got in (("at_keys", x[on], pred[b][0][on]),
                                    ("at_probes", probes, pred[b][1][[j, k + j]])):
                exact = np.array([float(alpha + beta * Fraction(v)) for v in pts.tolist()])
                if where == "at_probes":
                    got, exact = np.clip(got, 0, n), np.clip(exact, 0, n)
                st[f"{where}_{b}"][j] = np.abs(got - exact).max(initial=0.0)
            st[f"slope_{b}"][j] = (abs(Fraction(float(w[ids[j], 1])) - beta) / abs(beta)
                                   if beta else abs(float(w[ids[j], 1])))
        lo += m
    far = {b: np.maximum(st[f"at_keys_{b}"], st[f"at_probes_{b}"]) for b in ("dp", "p1")}
    ok = bool((st["keys"] <= DP_PRED_GAP).all() and (st["floors"] <= 1).all()
              and (far["dp"] <= np.maximum(DP_PRED_GAP, far["p1"])).all())
    worst = int(np.argmax(far["p1"]))

    def both(key, f=float):
        return {"dp": f(st[key + "_dp"].max()), "path1": f(st[key + "_p1"].max())}
    return {"outside_prediction_gap": float(st["keys"].max()),
            "outside_probe_gap": float(st["probes"].max()),
            "outside_probe_floor_diff": int(st["floors"].max()),
            "exact_line_max_dist_at_keys": both("at_keys"),
            "exact_line_max_dist_at_probes": both("at_probes"),
            "exact_slope_max_rel_err": both("slope"),
            "leaves_over_half_from_exact": {"dp": int((far["dp"] > DP_PRED_GAP).sum()),
                                            "path1": int((far["p1"] > DP_PRED_GAP).sum())},
            "leaves_dp_closer_to_exact": int((far["dp"] < far["p1"]).sum()),
            "leaves_path1_closer_to_exact": int((far["p1"] < far["dp"]).sum()),
            "farthest_leaf": {"leaf": int(ids[worst]), "keys": int(s1[worst] - s0[worst]),
                              "aug_points": int(a1[worst] - a0[worst]),
                              "distinct_x": int(st["distinct"][worst]),
                              "beta_exact": st["beta"][worst],
                              "beta_dp": float(leaf_w[ids[worst], 1]),
                              "beta_path1": float(want["leaf_w"][ids[worst], 1]),
                              "dist_dp": float(far["dp"][worst]),
                              "dist_path1": float(far["p1"][worst])},
            "ok": ok}


def dp_cross_check(keys_np, spec, B, rank_device, tmp):
    """10c: the dp build by PATH10_RANKS gloo ranks on ``rank_device``
    against the same by as many on the CPU, held to cross_check's
    tolerances; the card's ranks must launch K3 cubic and K6."""
    from rmi_tpu_torch.parallel import multihost
    runs = {}
    for device in (rank_device, "cpu"):
        runs[device] = multihost.run_ranks(
            dp_cross_rank, PATH10_RANKS, f"file://{tmp}/w10c_{device.replace(':', '')}",
            backend="gloo", device=device, args=(keys_np, spec, B, device),
            timeout=PATH10_TIMEOUT)
    for ranks in runs.values():
        if not all(_same_dp(ranks[0]["res"], r["res"]) for r in ranks[1:]):
            raise RuntimeError("10c: the ranks' builds differ")
    card, cpu = runs[rank_device][0], runs["cpu"][0]
    launched = {e for r in runs[rank_device] for e, c in r["launches"].items() if c}
    if rank_device != "cpu" and not {"rmi_sweep_max_cubic", "rmi_cubic_l1"} <= launched:
        raise RuntimeError(f"10c: K3 cubic and K6 not both launched: {sorted(launched)}")
    n = keys_np.shape[0]
    e_card, e_cpu = card["res"][2].astype(np.int64), cpu["res"][2].astype(np.int64)
    err_diff, id_diff = np.abs(e_card - e_cpu), np.abs(card["t"].astype(np.int64) - cpu["t"])
    leaves = (err_diff > 0) | (card["counts"] != cpu["counts"])

    def contrib(cnt, e):
        return cnt * np.log2(2.0 * e + 2.0)
    explained = float(np.abs(contrib(card["counts"], e_card)
                             - contrib(cpu["counts"], e_cpu))[leaves].sum()) / n
    m_card, m_cpu = card["res"][3], cpu["res"][3]
    d_log2 = abs(m_card["model_avg_log2_error"] - m_cpu["model_avg_log2_error"])
    res = {"spec": spec, "n": n, "B": B, "ranks": PATH10_RANKS,
           "max_err_card": m_card["model_max_error"], "max_err_cpu": m_cpu["model_max_error"],
           "avg_log2_card": m_card["model_avg_log2_error"],
           "avg_log2_cpu": m_cpu["model_avg_log2_error"], "avg_log2_abs_diff": d_log2,
           "explained_by_differing_leaves": explained,
           "leaf_ids_differing": int((id_diff > 0).sum()), "leaf_ids_max_diff": int(id_diff.max()),
           "leaf_errors_differing": int((err_diff > 0).sum()),
           "leaf_errors_max_diff": int(err_diff.max())}
    log("path 10c dp cross-check " + json.dumps(res))
    few = max(8, B // 256)
    if not (res["max_err_card"] == res["max_err_cpu"]
            and d_log2 <= METRIC_RTOL * abs(m_cpu["model_avg_log2_error"]) + explained
            and res["leaf_ids_max_diff"] <= 1 and res["leaf_errors_max_diff"] <= 1
            and res["leaf_ids_differing"] <= few and res["leaf_errors_differing"] <= few):
        raise RuntimeError("10c: dp build on the card and on the CPU disagree beyond tolerance")


def path1_host(rmi):
    """What path 10 holds its dp builds to: host copies of path 1's leaf
    errors, rows, spans (plain and augmented) and key counts per leaf,
    each leaf's epsilon-probe keys (the next leaf's first key, the
    previous leaf's last), and its avg_log2."""
    B = rmi.branching_factor
    t = two_layer.top_assignment(get_model(rmi.top_type), rmi.device_top_params, rmi.keys,
                                 rmi.norm_offset, rmi.norm_scale, B - 1)
    spans = seg.make_spans(t, B)
    del t
    _, next_key, prev_key = two_layer.lower_bound_fills(spans, rmi.keys, rmi.key_type)
    return {"leaf_errors": rmi.leaf_errors.cpu().numpy(),
            "leaf_w": rmi.device_leaf_params.cpu().numpy(),
            "top_w": rmi.device_top_params.cpu().numpy(),
            "counts": (spans.ends - spans.starts).cpu().numpy(),
            "starts": spans.starts.cpu().numpy(), "ends": spans.ends.cpu().numpy(),
            "aug": (spans.aug_starts.cpu().numpy(), spans.aug_ends.cpu().numpy()),
            "probes": (next_key.cpu().numpy(), prev_key.cpu().numpy()),
            "avg_log2": rmi.model_avg_log2_error, "norm": (rmi.norm_offset, rmi.norm_scale),
            "top_type": rmi.top_type, "leaf_type": rmi.leaf_type}


def dp_phase(data, queries, p1, p1_index, cross_n, seed, dev, rank_device="cuda:0",
             nccl=True):
    """Path 10: 10a the dp build of path 1's spec by PATH10_RANKS gloo ranks
    sharing ``rank_device``, each loading the keys from an SOSD file,
    checked against path 1 (``p1``, path1_host), bit-equal when built
    again, the bound over every key, and the sharded search of
    ``queries``' size; 10b the same build by one NCCL rank (``nccl``);
    10c dp_cross_check at ``cross_n`` keys; 10d per-device copies of path
    1's index (``p1_index``) over [dev, dev], serving twice ``queries``'
    size, each copy's half through K5's scatter entry.  Returns the
    launches of 10a's ranks, 10b's and 10d's search_sharded, and the rows
    of DP_TIMED, timed on 10b's calls (on 10a's rank 0 without ``nccl``)."""
    from rmi_tpu_torch.parallel import multihost, serve
    spec, B, entries = PATH10
    nq = queries.shape[0]
    launches = dict.fromkeys(_build.launches, 0)
    with tempfile.TemporaryDirectory(prefix="rmi_chip_smoke_dp_") as tmp:
        path = os.path.join(tmp, "books_uint64")
        t0 = time.perf_counter()
        rdata.write_sosd_file(path, keymod.from_image(data.keys, data.key_type))
        log(f"path 10: {data.n} keys written to an SOSD file in "
            f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        ranks = multihost.run_ranks(
            dp_rank, PATH10_RANKS, f"file://{tmp}/w10a", backend="gloo", device=rank_device,
            args=(path, spec, B, nq, seed, rank_device, True, "replay" if nccl else "both"),
            timeout=PATH10_TIMEOUT)
        log(f"path 10a: {PATH10_RANKS} gloo ranks on {rank_device}, {spec} {B}, "
            f"{time.perf_counter() - t0:.3f} s with their start")
        r0 = ranks[0]
        for r in ranks:
            log(f"path 10a rank {r['rank']}: cold build {r['walls'][0]:.4f} s, warm "
                f"{', '.join(f'{w:.4f}' for w in r['walls'][1:])} s; timed build "
                f"{r['timed_build_s']:.4f} s of which {r['collective_s']:.4f} s in "
                f"{r['collectives']} collectives (host clock, the card synchronized "
                f"around each); peak device memory {r['peak_gib']} GiB; bound: "
                f"{r['violations']} violations on {r['checked_keys']} keys; search of "
                f"{r['part']} queries ({r['route']}) "
                f"{r['search_alone_s'][PATH10_SERVES // 2]:.5f} s, with "
                f"the all_gather {r['serve_s'][PATH10_SERVES // 2]:.5f} s (median of "
                f"{PATH10_SERVES}); launches {json.dumps({e: c for e, c in r['launches'].items() if c})}")
        warm = sorted(r0["walls"][1:])[PATH10_WARM // 2]
        rate = nq / r0["serve_s"][PATH10_SERVES // 2]
        log(f"path 10a: dp build warm {warm:.4f} s (rank 0, median of {PATH10_WARM}); "
            f"sharded search {rate:.6g} lookups/s ({nq} queries, {PATH10_RANKS} ranks "
            f"sharing one card, with the all_gather)")
        log(f"path 10a replays (rank 0): {json.dumps(r0['replays'])}")
        for spec_b, (wall, peak) in r0["specs"].items():
            log(f"path 10a rank 0: dp build {spec_b} warm {wall:.4f} s, peak {peak} GiB")
        rows = r0.get("rows", {})
        if not all(_same_dp(r0["res"], r["res"]) for r in ranks[1:]):
            raise RuntimeError("10a: the ranks returned different builds")
        if not all(r["same_build"] for r in ranks):
            raise RuntimeError("10a: the same shards gave different dp builds")
        if sum(r["checked_keys"] for r in ranks) != data.n or any(r["violations"]
                                                                  for r in ranks):
            raise RuntimeError("10a: bound |guess - yfix| <= err violated")
        if any(r["mismatches"] for r in ranks) or not all(r["replica_equal"] for r in ranks):
            raise RuntimeError("10a: sharded search disagrees with torch.searchsorted")
        dp_tolerance("path 10a", r0["res"], p1, data)
        for r in ranks:
            launches = {e: launches[e] + r["launches"][e] for e in launches}
        missing = [e for e in entries if launches[e] <= 0]
        if missing:
            raise RuntimeError(f"path 10a: kernels not launched on the path: {missing}")
        rate10a = rate
        if nccl:
            (r,) = multihost.run_ranks(
                dp_rank, 1, f"file://{tmp}/w10b", backend="nccl", device=rank_device,
                args=(path, spec, B, nq, seed, rank_device, False, "time"),
                timeout=PATH10_TIMEOUT)
            log(f"path 10b: one NCCL rank, cold build {r['walls'][0]:.4f} s, warm "
                f"{', '.join(f'{w:.4f}' for w in r['walls'][1:])} s, timed "
                f"{r['timed_build_s']:.4f} s of which {r['collective_s']:.4f} s in "
                f"{r['collectives']} collectives; peak {r['peak_gib']} GiB; "
                f"{r['violations']} violations on {r['checked_keys']} keys")
            for spec_b, (wall, peak) in r["specs"].items():
                log(f"path 10b: dp build {spec_b} warm {wall:.4f} s, peak {peak} GiB")
            log(f"path 10b replays: {json.dumps(r['replays'])}")
            rows = r["rows"]
            if not r["same_build"] or r["violations"]:
                raise RuntimeError("10b: the NCCL rank's build is not reproducible or wrong")
            dp_tolerance("path 10b", r["res"], p1, data)
            launches = {e: launches[e] + r["launches"][e] for e in launches}
        del ranks, r0
    cross_keys = keymod.from_image(rdata.books_like_on_device(cross_n, seed + 1, dev).cpu())
    with tempfile.TemporaryDirectory(prefix="rmi_chip_smoke_dpx_") as tmp:
        dp_cross_check(cross_keys, PATH10C[0], PATH10C[1], rank_device, tmp)

    # 10d: per-device copies of path 1's index in this process, each
    # copy's half of the batch past search's density gate
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    q2 = make_queries(data.keys, 2 * nq, gen)
    rmis = serve.replicate_rmi_per_device(p1_index, [dev, dev])
    routes = [search_route(r, -(-q2.shape[0] // 2)) for r in rmis]
    for entry in _build.launches:
        _build.launches[entry] = 0
    got = serve.search_sharded(rmis, q2)
    _sync(dev)
    counts = dict(_build.launches)
    launches = {e: launches[e] + c for e, c in counts.items()}
    mism = mismatches(data.keys, q2, got)
    one = cuda_ms(lambda: search(p1_index, q2), 5)
    two = cuda_ms(lambda: serve.search_sharded(rmis, q2), 5)
    log(f"path 10d: search_sharded over [{dev}, {dev}], {q2.shape[0]} queries "
        f"({routes} a copy; path 1's search: {search_route(p1_index, q2.shape[0])}): "
        f"{mism} mismatches; {q2.shape[0] / (two / 1e3):.6g} lookups/s against path 1's "
        f"search {q2.shape[0] / (one / 1e3):.6g} on the same batch, and 10a's four ranks "
        f"{rate10a:.6g} on {nq} (one card each time); launches "
        f"{json.dumps({e: c for e, c in counts.items() if c})}")
    if mism:
        raise RuntimeError("10d: search_sharded disagrees with torch.searchsorted")
    missing = [e for e in PATH10D if counts[e] <= 0]
    if routes != ["sort", "sort"] or missing:
        raise RuntimeError(f"10d: the copies did not serve through K5's scatter entry: "
                           f"routes {routes}, not launched {missing}")
    return launches, rows



# D runs at its narrowest and widest rows only: the rate table over all
# widths is tools/probe_torch_kernels.py's
# path 11: the reference's five other SOSD CI configurations
# (tests/test_sosd.py:43-50) on SOSD_SYNTH.json's keys, each through the CLI
# with its row's flags, held to the row's RMI_SIZE: (config, key kind,
# models, branching factor, --bounded line size or None)
PATH11 = [("simple_model_wiki", "wiki", "cubic,linear", 262144, None),
          ("simple_model_osm", "osm", "robust_linear,linear", 262144, None),
          ("radix_model_wiki", "wiki", "radix,linear", 1024, None),
          ("cache_fix_wiki", "wiki", "linear_spline,linear", 4194304, 8),
          ("cache_fix_osm", "osm", "cubic,linear", 786432, 8)]
SOSD_NAMES = {"wiki": "wiki_ts_200M_uint64", "osm": "osm_cellids_200M_uint64"}
# what every configuration's build and lookup launch (linear leaves: FixDups,
# the leaf fit, K3, the run-length pass, K4's epsilon probes and its fused
# lookup); a cachefix lookup adds rmi_cachefix_interp
PATH11_BUILD = ("rmi_fixdups", "rmi_aug_fit_moments", "rmi_sweep_max_linear", RUN_MAX,
                "rmi_leaf_eval_linear", "rmi_lookup_linear")
CACHEFIX = ("rmi_cachefix_interp", "rmi_bounded_lower_bound")
# the entries each search route launches besides the fused lookup
ROUTE_ENTRIES = {"sort": ("rmi_serve_sorted_scatter",), "hier": ("rmi_hier_resolve",),
                 "cachefix": CACHEFIX, "bounded": ("rmi_bounded_lower_bound",),
                 "packed": (), "packed_wide": ()}
# the configuration whose cachefix lookup gives rmi_cachefix_interp's row
PATH11_TIMED = "cache_fix_osm"


def sosd_rows():
    """SOSD_SYNTH.json's rows (rmi_tpu's builds on a TPU, df64), by config."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "SOSD_SYNTH.json")
    with open(path) as f:
        return {r["config"]: r for r in map(json.loads, filter(str.strip, f))}


def cachefix_route_before(index, k):
    """A cachefix lookup's positions by the route the kernel replaced: the
    same fused lookup, then the interpolation's plain version."""
    guess, err = _rmi_lookup(index, k)
    return cachefix_kernel.cachefix_interp_plain(index.keys, index.spline_vals_cache, k, guess,
                                                 err, index.cache_fix[0], index.num_data_rows)


def cachefix_lookup_ms(label, index, k):
    """The cachefix lookup of the keys ``k`` (one fused lookup and one
    rmi_cachefix_interp) beside the route it replaced, both timed with CUDA
    events, the answers equal."""
    same = torch.equal(lookup(index, k)[0], cachefix_route_before(index, k))
    new = row_ms(lambda: lookup(index, k), 10)
    old = row_ms(lambda: cachefix_route_before(index, k), 3)
    log(f"{label} cachefix lookup of {k.shape[0]} keys: {spread(new)}; the route it replaced "
        f"(the interpolation's plain version) {spread(old)}; equal {same}")
    log(f"{label} cachefix lookup " + json.dumps({"ms": new[0], "before_ms": old[0],
                                                   "keys": k.shape[0]}))
    if not same:
        raise RuntimeError(f"{label}: the cachefix lookup differs from the route it replaced")


def cachefix_missed_ms(label, index, keys, nq):
    """A cachefix search batch made only of queries whose window misses
    their lower bound: each key that ends a run of equal keys, plus one
    (not a key), where the index's position +- (line + 1) leaves out the
    run's end; at most nq of them.  Its time (CUDA events) beside a batch
    of as many keys drawn at random, both exact; logged, no gate on the
    time."""
    run_end = torch.nonzero((keys[1:-1] == keys[:-2]) & (keys[2:] > keys[1:-1] + 1)).flatten()
    q = keys[run_end + 1] + 1
    pos, err = lookup(index, q)
    lb = torch.searchsorted(keys, q)
    q = q[(lb < pos - err - 1) | (lb > pos + err + 2)][:nq]
    hit = keys[torch.randint(0, keys.shape[0], (q.shape[0],), device=keys.device,
                             generator=torch.Generator(device=keys.device).manual_seed(5))]
    res = {"queries": q.shape[0], "run_ends": run_end.shape[0]}
    if q.shape[0]:
        res["missed_ms"] = row_ms(lambda: search(index, q, keys=keys), 10)[0]
        res["keys_ms"] = row_ms(lambda: search(index, hit, keys=keys), 10)[0]
        res["mismatches"] = (mismatches(keys, q, search(index, q, keys=keys))
                             + mismatches(keys, hit, search(index, hit, keys=keys)))
    log(f"{label} cachefix search of queries whose window misses " + json.dumps(res))
    if res.get("mismatches"):
        raise RuntimeError(f"{label}: the cachefix search of missed windows is not exact")


def sosd_config(files, row, ref, gen, nq, cross_n, seed, dev):
    """One PATH11 configuration on its SOSD file (sosd_file), through the
    CLI with the row's flags and --stats-file, in a temporary directory:
    RMI_SIZE equal to SOSD_SYNTH.json's ``ref`` row; the artifact loaded
    back onto the card with |guess - lb| <= err over every key (cachefix:
    |pos - lb| <= line and err = line), search of nq queries over the
    file's key range exact (cachefix: with the original keys); every entry
    of its build, lookup and search route launched; the build again on the
    card (warm; of a cachefix index, the RMI over its knots), its metrics
    the CLI's; max_err with its leaf (max_leaf), avg_log2, the cold and warm
    build, the host spline and the peak device memory beside the TPU row,
    no gate; its kernel calls replayed against their plain versions and
    the card against the CPU at cross_n keys of the same kind and seed
    (uncounted); a cachefix index's lookup of nq keys drawn at random
    timed beside the route it replaced, and rmi_cachefix_interp's
    kernels-line row (check_kernels), which it returns (None for the
    other rows)."""
    config, kind, spec, B, line = row
    n = files["n"]
    path = sosd_file(files, kind, n)
    bounded = ["--bounded", str(line)] if line else []
    timers = {"load": (rmi_tpu_torch, "load_data"),
              "train": (train_api, "train") if line else (rmi_tpu_torch, "train"),
              "output_rmi": (rmi_tpu_torch, "output_rmi")}
    if line:
        timers["spline (native, host)"] = (native, "cache_fix")
    before = dict(_build.launches)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = Recorder()
    with tempfile.TemporaryDirectory(prefix="rmi_chip_smoke_sosd_") as tmp:
        with rec:
            total, t = run_cli(tmp, [path, config, spec, str(B), *bounded, "--stats-file",
                                     "stats.json", "--data-path", "rmi_data"], timers)
        peak = torch.cuda.max_memory_allocated()
        stats = json.load(open(os.path.join(tmp, "stats.json")))
        meta_path = os.path.join(tmp, "rmi_data", f"{config}.json")
        size = stats["size binary search"]
        # a cachefix size counts the knots, which follow the keys: a shorter
        # run holds it to the top's bytes + 24 B + 16 knots
        want = ref["size_bytes"]
        if line and n != 200_000_000:      # the top's parameters, 24 B a leaf, 16 a knot
            want = (8 * get_model(spec.split(",")[0]).ppm + 24 * B
                    + 16 * json.load(open(meta_path))["cache_fix"]["num_points"])
        log(f"path 11 {config} cli {spec} {B} {' '.join(bounded)}: {total:.3f} s "
            f"({t.line()}); RMI_SIZE {size} (want {want}; SOSD_SYNTH.json "
            f"{ref['size_bytes']})")
        if size != want:
            raise RuntimeError(f"path 11 {config}: RMI_SIZE {size}, not {want}")
        data = rmi_tpu_torch.load_data(path)
        keys = data.keys
        loaded = rmi_tpu_torch.load_artifact(meta_path, keys=None if line else keys)
    viol = 0
    sample = keys[torch.randint(0, n, (nq,), generator=gen, device=keys.device)]
    with rec:        # the lookup replayed and timed: nq keys drawn at random
        lookup(loaded, sample)
    for i in range(0, n, PATH9_CHUNK):
        k = keys[i:i + PATH9_CHUNK]
        g, e = lookup(loaded, k)
        lb = torch.searchsorted(keys, k, side="left")
        viol += (int(((g - lb).abs() > line).sum()) + int((e != line).sum()) if line
                 else int(((g - lb).abs() > e).sum()))
    del g, e, lb, k
    q = make_queries(keys, nq, gen)
    search_keys = keys if line else None
    route = search_route(loaded, nq, search_keys)
    with rec:
        got, by_search = launched(lambda: search(loaded, q, keys=search_keys))
    mism = mismatches(keys, q, got)
    log(f"path 11 {config} artifact on the card: {viol} bound violations over all {n} keys "
        f"({'|pos - lb| > ' + str(line) + ' or err != ' + str(line) if line else '|guess - lb| > err'}), "
        f"search {mism} mismatches on {nq} queries (route {route}, launches "
        f"{json.dumps(by_search)})")
    if viol or mism:
        raise RuntimeError(f"path 11 {config}: the bound or search is broken")
    del got
    counts = {e: c - before[e] for e, c in _build.launches.items()}
    entries = (*PATH11_BUILD, *ROUTE_ENTRIES[route], *(("rmi_cachefix_interp",) if line else ()))
    missing = [e for e in entries if counts[e] <= 0]
    log(f"path 11 {config} launches: {json.dumps({e: c for e, c in counts.items() if c})}")
    if missing:
        raise RuntimeError(f"path 11 {config}: kernels not launched: {missing}")

    # the build again (warm), its metrics the CLI's
    spline_s = t.seconds.get("spline (native, host)")
    with uncounted():
        inner = rdata.RMIDataset(loaded.keys, KeyType.U64) if line else data
        t0 = time.perf_counter()
        rmi = rmi_tpu_torch.train(inner, spec, B)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    got = (rmi.model_max_error, rmi.model_avg_log2_error)
    want = (stats["max error"], stats["average log2 error"])
    where = max_leaf(rmi)
    res = {"config": config, "models": spec, "branching_factor": B, "bounded": line,
           "rmi_size": size, "max_err_leaf": where, "avg_log2": rmi.model_avg_log2_error,
           "build_cold_s": t.seconds["train"], "build_warm_s": warm, "spline_s": spline_s,
           "cli_s": total, "peak_device_gib": peak / 2**30,
           "knots": rmi.num_rmi_rows if line else None,
           "tpu_row": {k: ref[k] for k in ("max_err", "avg_log2", "size_bytes", "build_s")}}
    log(f"path 11 {config}: max_err {where['max_err']} at leaf {where['leaf']} of {B} "
        f"({where['keys_routed']} {'knots' if line else 'keys'} routed there; final leaf "
        f"{where['final_leaf']}, empty {where['empty']}; the final leaf "
        f"{where['final_leaf_keys']}, err {where['final_leaf_err']}) beside the TPU row's "
        f"{ref['max_err']}; avg_log2 {rmi.model_avg_log2_error!r} beside "
        f"{ref['avg_log2']!r}; build cold {t.seconds['train']:.4f} s, warm {warm:.4f} s"
        f"{f', host spline {spline_s:.3f} s' if line else ''}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log("path 11 " + json.dumps(res))
    if got != want:
        raise RuntimeError(f"path 11 {config}: the build again gave {got}, the CLI {want}")
    del rmi, t
    kernel_row = None
    with uncounted():
        if line:
            cachefix_lookup_ms(f"path 11 {config}", loaded, sample)
        if line and kind == "wiki":
            cachefix_missed_ms(f"path 11 {config}", loaded, keys, nq)
        del loaded, data, keys, q, sample
        torch.cuda.empty_cache()
        check_kernels(rec, {}, entries, timed=False)
        if line:       # rmi_cachefix_interp beside its plain version and its bound
            kernel_row = check_kernels(rec, counts, ("rmi_cachefix_interp",))
        del rec
        torch.cuda.empty_cache()
        ckeys = rdata.RMIDataset.from_numpy(
            rdata.synthetic_dataset(kind, cross_n, KeyType.U64, seed=WIKI_SEED),
            device=dev).keys
        cB = max(64, (B * cross_n) // n)
        sparse = bool(line) and res["knots"] < 16 * B     # a few knots a leaf
        cross_check(spec, cross_n, cB, seed, dev, keys=ckeys, line=line, sparse=sparse)
    return kernel_row


def sosd_phase(files, gen, nq, cross_n, seed, dev):
    """Path 11, the launches counted from 0: the PATH11 configurations in
    turn (sosd_config).  Returns the launches and rmi_cachefix_interp's
    kernels-line row from PATH11_TIMED's lookup of nq keys."""
    for entry in _build.launches:
        _build.launches[entry] = 0
    refs, rows = sosd_rows(), {}
    for i, row in enumerate(PATH11):
        t0 = time.perf_counter()
        out = sosd_config(files, row, refs[row[0]], gen, nq, cross_n, seed + i, dev)
        if row[0] == PATH11_TIMED:
            rows = out
        log(f"path 11 {row[0]}: {time.perf_counter() - t0:.1f} s")
    counts = dict(_build.launches)
    log(f"path 11 launches: {json.dumps(counts)}")
    missing = [e for e in (*PATH11_BUILD, *CACHEFIX) if counts[e] <= 0]
    if missing:
        raise RuntimeError(f"path 11: kernels not launched on the path: {missing}")
    return counts, rows


PROBE_RING_WIDTHS = (128, 2048)
PROBE_TRACED = 200        # calls per probe in its device-time trace
HOST_CALLS = 2000         # calls per host-time measurement


def device_us(fn, calls=PROBE_TRACED):
    """Device microseconds per call of ``fn``: its CUDA kernels' time in
    a profiler trace of ``calls`` calls, as tools/time_torch_launch.py
    measures it."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()) / calls


def host_us(fn, calls=HOST_CALLS):
    """Host microseconds per call of ``fn``, unsynchronized, after a
    warm-up, as tools/time_torch_launch.py measures it."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def ring_walk_total(nrows, marked):
    """The TPU probe's sum over its walk: 4096.0 on the table of ones,
    sum of ((j * 7919) mod 2^17) mod 251 on the marked one."""
    if not marked:
        return float(probe_kernels.RING_ITERS)
    return float(sum((j * probe_kernels.RING_STEP) % nrows % 251
                     for j in range(probe_kernels.RING_ITERS)))


def probe_phase(dev):
    """The card probes' own path: every probe's main call (probe.main: D's
    whole-card form, once per width of PROBE_RING_WIDTHS) run once on its
    probe's inputs with the launches counted from 0; then each output
    held equal to its plain version's on the card, and the kernel timed
    beside it.  D is timed cold, on views of a table whose rows are not
    in L2 (probe_kernels.ring_cold_views), as a walk of a table that is
    read once finds them; its one-block rate, the per-SM question, is
    logged beside its row.  Returns the kernels rows."""
    probes = probe_kernels.PROBES
    cases = [(p, w) for p in probes
             for w in (PROBE_RING_WIDTHS if p.inputs is None else (None,))]
    inputs = [probe_kernels.probe_inputs(p, dev, width=w or 128) for p, w in cases]

    for entry in _build.launches:
        _build.launches[entry] = 0
    outputs = [p.main(*args) for (p, _), args in zip(cases, inputs)]
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    missing = [p.entry for p in probes if launches[p.entry] <= 0]
    if missing:
        raise RuntimeError(f"probes not launched: {missing}")

    rows = {}
    for (probe, width), args, got in zip(cases, inputs, outputs):
        want = probe.main_plain(*args)
        run, run_plain = (lambda: probe.main(*args)), (lambda: probe.main_plain(*args))
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(f"probe {probe.key} ({probe.entry}): kernel disagrees "
                               f"with its plain version")
        if probe.inputs is None:       # D: the walk's total, and the marked table
            nrows = args[0].shape[0]
            marked = probe_kernels.ring_table(width, dev, marked=True)
            card = probe.main(marked)
            totals = (float(got.double().sum()), float(card.double().sum()))
            if (not torch.equal(card, probe.main_plain(marked))
                    or totals != (ring_walk_total(nrows, False), ring_walk_total(nrows, True))
                    or not torch.equal(probe.wrapper(marked), probe.plain(marked))):
                raise RuntimeError(f"probe D, width {width}: wrong sums {totals}")
            del marked
            for warps in (1, probe_kernels.RING_WARPS):
                ns = cuda_ms(lambda: probe.wrapper(args[0], warps=warps), 3) * 1e6 / (
                    probe_kernels.RING_ITERS * warps)
                log(f"probe D width {width}: one block, {warps} issuing warp"
                    f"{'s' if warps > 1 else ''}: {ns:.2f} ns a row")
            views = itertools.cycle(probe_kernels.ring_cold_views(width, dev))
            run = lambda: probe.main(next(views))                 # noqa: E731
            run_plain = lambda: probe.main_plain(next(views))     # noqa: E731
        idx = [a.long() for a in args if a.dtype == torch.int32]
        # one PyTorch call that computes the same, where there is one: the
        # pair compare and the copy ring have none, and torch 2.11 has no
        # uint64 compare on the card ("compare_cuda" not implemented)
        lib = {"A": lambda: torch.mul(args[0], 2.0),
               "B1": lambda: torch.lt(args[0], args[1]),
               "C1": lambda: torch.index_select(args[0], 0, idx[0]),
               "C2": lambda: torch.take(args[0], idx[0]),
               "C3": lambda: torch.gather(args[0], 1, idx[0]),
               "E": lambda: torch.index_select(args[1], 0, idx[0])}.get(probe.key)
        ms = row_ms(run, 20)
        plain_ms = row_ms(run_plain, 20)
        library_ms = None if lib is None else row_ms(lib, 20)
        if probe.inputs is None:       # the rows D fetches, not its whole table
            nbytes = probe_kernels.RING_ITERS * width * 4 + _nbytes(got)
            elems = probe_kernels.RING_ITERS
        else:
            nbytes, elems = _nbytes(*args, got), got.numel()
        peak = INT_OPS_PER_S if got.dtype == torch.int32 else F32_OPS_PER_S
        bound_ms = max(nbytes / HBM_BYTES_PER_S, elems / peak) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= elems / peak else "operations"
        name = f"probe {probe.key} {probe.entry}" + (f" width {width}" if width else "")
        log(f"{name}: equal to its plain version; {spread(ms)} vs plain {spread(plain_ms)}, "
            f"library {library_ms and spread(library_ms)}, bound {bound_ms:.6f} ms "
            f"({bound_by}: {nbytes} B)")
        lib_us = None if lib is None else f"{device_us(lib):.4f} us"
        log(f"{name}: device time per call (profiler, {PROBE_TRACED} calls) "
            f"{device_us(run):.4f} us vs library {lib_us}")
        lib_host = None if lib is None else f"{host_us(lib):.3f} us"
        log(f"{name}: host time per call ({HOST_CALLS} calls) "
            f"{host_us(run):.3f} us vs library {lib_host}")
        # one row per entry: D's is its widest call, the last of its cases
        rows[probe.entry] = {
            "name": probe.entry, "route": "cuda",
            "source": "rmi_tpu_torch/csrc/probes.cu", "replaces": probe.replaces,
            "launches": launches[probe.entry], "max_abs_err": 0, "ms": ms[0],
            "plain_ms": plain_ms[0], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library_ms is None else library_ms[0]}
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000_000, help="keys")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    n = args.n
    nq = min(1 << 22, n)          # search queries, and keys of the bound check
    cross_n = min(1 << 20, n)

    # 1. the card
    walls = Walls()
    dev = config.require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. the kernels
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall, compile and link "
        f"{_build.build_info['seconds']:.2f} s ({_build.build_info['path']})")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas " + line.split("ptxas info    :")[-1].strip())
        elif line.endswith(" s") and ": " in line:      # each step's wall time
            log("  build " + line)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    keys = rdata.books_like_on_device(n, args.seed, dev)
    data = rdata.RMIDataset(keys, KeyType.U64)
    torch.cuda.synchronize()
    log(f"keys: n={n} made on the card in {time.perf_counter() - t0:.2f} s")
    keys_again = torch.equal(keys, rdata.books_like_on_device(n, args.seed, dev))
    log(f"reproducible: keys made twice equal {keys_again}")
    if not keys_again:
        raise RuntimeError("the same seed gave different keys")
    queries = make_queries(keys, nq, gen)
    rows, launches = {}, dict.fromkeys(_build.launches, 0)
    walls.lap("the card, the kernels' build and the keys")

    # 3-8. path 1
    spec, B, _, replayed = PATH1
    rmi, rec, counts = drive(PATH1, data, queries, gen)
    k5_phase(rmi, keys, queries)
    serving_curve(rmi, keys, gen)
    stage_a_trace(data, spec, B)
    # what path 6a's artifact must reproduce
    p1 = {"metrics": (rmi.model_max_error, rmi.model_max_error_idx,
                      rmi.model_avg_log2_error),
          "lookup": lookup(rmi, queries), "leaf": top_leaf(rmi, queries)}
    p1_dp = path1_host(rmi)      # what path 10's dp builds are held to
    p1_index = dataclasses.replace(rmi)     # path 10d's index, its caches dropped
    del rmi
    legacy_calls(rec)
    rows.update(check_kernels(rec, counts, replayed))
    launches = {e: launches[e] + counts[e] for e in launches}
    del rec
    torch.cuda.empty_cache()
    cross_check(spec, cross_n, max(64, (B * cross_n) // n), args.seed + 2, dev)
    walls.lap("path 1")

    # 9-11. paths 2, 3 and 4
    for seed, path in enumerate((PATH2, PATH3, PATH4), args.seed + 3):
        spec, B, _, replayed = path
        rmi, rec, counts = drive(path, data, queries, gen)
        del rmi
        fit_timed = ()
        if path is PATH3:    # its two builds' leaf fits
            fits = (counts["rmi_aug_fit_log_moments"], counts["rmi_aug_moments_weighted"])
            log(f"path 3 leaf fit launches (rmi_aug_fit_log_moments, K2 weighted): {fits}")
            if fits != (2, 0):
                raise RuntimeError(f"path 3's two builds launched {fits}, not (2, 0)")
        if path is PATH4:    # the fit's xx form timed, logged
            fit_timed = ("rmi_aug_fit_moments",)
            log("path 4 rmi_aug_fit_moments, xx form " + json.dumps(
                check_kernels(rec, counts, fit_timed)["rmi_aug_fit_moments"]))
        rows.update(check_kernels(rec, counts, replayed))
        # their rows stay path 1's
        check_kernels(rec, counts, PACKED + tuple(
            e for e in STAGE_A + FIT if e in path[2] and e not in fit_timed), timed=False)
        launches = {e: launches[e] + counts[e] for e in launches}
        del rec
        torch.cuda.empty_cache()
        cross_check(spec, cross_n, max(64, (B * cross_n) // n), seed, dev)
        walls.lap(f"path {seed - args.seed - 1}")

    # 11b. path 5: an integer top; its fused lookup timed beside the two
    # steps and path 1's, its kernels replayed, their rows path 1's
    rmi, rec, counts = drive(PATH5, data, queries, gen)
    serving_curve(rmi, keys, gen)
    del rmi
    p5_rows = check_kernels(rec, counts, ("rmi_lookup_linear", *PACKED, TABLE_FIT))
    rows[TABLE_FIT] = p5_rows[TABLE_FIT]
    log("path 5 packed kernels " + json.dumps({e: p5_rows[e] for e in PACKED}))
    p5 = p5_rows["rmi_lookup_linear"]
    p1_row = rows["rmi_lookup_linear"]
    log(f"path 5 lookup {PATH5[0]} at {nq} keys: fused {p5['ms']:.4f} ms (bound "
        f"{p5['bound_ms']:.4f}), plain {p5['plain_ms']:.4f} ms; path 1's fused "
        f"{p1_row['ms']:.4f} ms (bound {p1_row['bound_ms']:.4f})")
    log("path 5 lookup " + json.dumps(p5))
    check_kernels(rec, counts, PATH5[3], timed=False)
    launches = {e: launches[e] + counts[e] for e in launches}
    del rec
    torch.cuda.empty_cache()
    cross_check(PATH5[0], cross_n, max(64, (PATH5[1] * cross_n) // n), args.seed + 7, dev)
    walls.lap("path 5")

    # 11c. path 6: the compile path through the CLI, its kernels replayed
    rec, counts = compile_phase(data, queries, gen, p1)
    del p1
    check_kernels(rec, counts, PATH6, timed=False)
    launches = {e: launches[e] + counts[e] for e in launches}
    del rec
    torch.cuda.empty_cache()
    walls.lap("path 6")

    # 11d. the rest of the integer models
    zoo_phase(data, gen, nq, cross_n, args.seed + 8, dev)
    walls.lap("the zoo")

    # 11e. path 7: f64 keys; 11f. path 8: u32 keys and the hier plan
    counts = path7_phase(keys, gen, nq, cross_n, args.seed + 9, dev, rows)
    launches = {e: launches[e] + counts[e] for e in launches}
    torch.cuda.empty_cache()
    walls.lap("path 7")
    counts, p8_rows = path8_phase(keys, gen, nq, cross_n, args.seed + 10, dev)
    rows.update(p8_rows)
    launches = {e: launches[e] + counts[e] for e in launches}
    torch.cuda.empty_cache()
    walls.lap("path 8")

    # 11g. path 9: the optimizer (max_size_wiki, --optimize, card against
    # CPU, the largest disk-profile point); its wiki keys' SOSD file kept
    # for path 11
    sosd_dir = tempfile.TemporaryDirectory(prefix="rmi_chip_smoke_keys_")
    files = {"dir": sosd_dir.name, "n": n}
    counts = optimizer_phase(data, gen, nq, cross_n, args.seed + 11, dev, files)
    launches = {e: launches[e] + counts[e] for e in launches}
    torch.cuda.empty_cache()
    walls.lap("path 9")

    # 11h. path 10: the data-parallel build and sharded serving, by ranks
    # that share the card
    counts, p10_rows = dp_phase(data, queries, p1_dp, p1_index, cross_n, args.seed + 12, dev)
    rows.update(p10_rows)
    launches = {e: launches[e] + counts[e] for e in launches}
    del p1_dp, p1_index
    torch.cuda.empty_cache()
    walls.lap("path 10")

    # 11i. path 11: the reference's five other SOSD CI configurations on
    # their own keys, through the CLI
    del queries, data, keys
    torch.cuda.empty_cache()
    counts, p11_rows = sosd_phase(files, gen, nq, cross_n, args.seed + 13, dev)
    rows.update(p11_rows)
    launches = {e: launches[e] + counts[e] for e in launches}
    sosd_dir.cleanup()
    torch.cuda.empty_cache()
    walls.lap("path 11")

    # 12. lognormal leaves: the card against the CPU, and their K3 and K4
    # calls replayed; these launches are not the main path's
    spec, B, _, replayed = LOGNORMAL
    rec = Recorder()
    for b in (max(64, (B * cross_n) // n), cross_n // 64):
        cross_check(spec, cross_n, b, args.seed + 6, dev, rec)
    for entry, row in check_kernels(rec, dict.fromkeys(_build.launches, 0),
                                    replayed).items():
        log(f"lognormal replay {entry}: max abs err {row['max_abs_err']}")
    del rec

    for entry, row in rows.items():
        row["launches"] = launches[entry]
    # 13. the card probes
    rows.update(probe_phase(dev))
    walls.lap("the lognormal cross-check and the probes")
    print(json.dumps({"kernels": [rows[entry] for entry, *_ in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
