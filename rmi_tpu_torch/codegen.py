"""C++ source emission (counterpart of rmi_tpu/codegen.py): ``<ns>.h``,
``<ns>_data.h`` and ``<ns>.cpp`` with the reference's public surface
(README.md:44-63), byte for byte what rmi_tpu emits for the same index:

    namespace ns {
      bool load(char const* dataPath);
      void cleanup();
      const size_t RMI_SIZE; const uint64_t BUILD_TIME_NS; const char NAME[];
      uint64_t lookup(KEY key, size_t* err);   // err omitted w/ --no-errors
    }

As in rmi_tpu, leaf parameters with zipped errors are a packed struct
array and the math helpers a per-namespace section, while the on-disk
layout, the model arithmetic (fma chains, the exp1 and phi
approximations) and the clamps are the reference generator's
(codegen.rs:450-754); a main program written for the reference's
output compiles against these sources unchanged.  The model expressions read
the raw parameters (``rmi.raw_top``).
"""

from __future__ import annotations

import os

import numpy as np

from rmi_tpu_torch.models import get_model
from rmi_tpu_torch.serialize import rmi_size, top_constants

_MATH_HELPERS = r"""
inline double rmi_exp1(double x) {
  // (1 + x/64)^64 — shared approximation (stdlib.rs:17-33)
  double v = 1.0 + x / 64.0;
  v *= v; v *= v; v *= v; v *= v; v *= v; v *= v;
  return v;
}

inline double rmi_phi(double x) {
  return 1.0 / (1.0 + rmi_exp1(-1.65451 * x));
}

inline double rmi_linear(double alpha, double beta, double x) {
  return std::fma(beta, x, alpha);
}

inline double rmi_loglinear(double alpha, double beta, double x) {
  return rmi_exp1(std::fma(beta, x, alpha));
}

inline double rmi_cubic(double a, double b, double c, double d, double x) {
  return std::fma(std::fma(std::fma(a, x, b), x, c), x, d);
}

inline double rmi_ncdf(double mean, double stdev, double scale, double x) {
  return rmi_phi((x - mean) / stdev) * scale;
}

inline double rmi_lncdf(double mean, double stdev, double scale, double x) {
  return rmi_phi((fmax(0.0, log(x)) - mean) / stdev) * scale;
}

inline uint64_t rmi_radix(uint64_t prefix, uint64_t bits, uint64_t x) {
  return (x << prefix) >> (64 - bits);
}

inline uint64_t rmi_bradix_high(uint64_t prefix, uint64_t bits,
                                uint64_t clamp, uint64_t x) {
  uint64_t v = (x << prefix) >> (64 - bits);
  return v > clamp ? clamp : v;
}

inline uint64_t rmi_bradix_low(uint64_t prefix, uint64_t bits,
                               uint64_t clamp, uint64_t x) {
  uint64_t v = (x << prefix) >> (64 - bits);
  return v < clamp ? 0 : v - clamp;
}

inline size_t FCLAMP(double inp, double bound) {
  if (inp < 0.0) return 0;
  return (inp > bound ? bound : (size_t)inp);
}

inline uint64_t rmi_bs_upper_bound(const uint64_t* a, uint64_t n,
                                   uint64_t key) {
  // branchless upper_bound (stdlib.rs BinarySearch equivalent)
  uint64_t lo = 0, hi = n;
  while (lo < hi) {
    uint64_t mid = lo + (hi - lo) / 2;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}
"""


def _top_eval_expr(rmi, const_names):
    """(setup_lines, expression, is_int) for the top-model prediction."""
    t = rmi.top_type
    c = const_names
    if t in ("linear", "robust_linear", "linear_spline"):
        return [], f"rmi_linear({c[0]}, {c[1]}, (double)key)", False
    if t == "loglinear":
        return [], f"rmi_loglinear({c[0]}, {c[1]}, (double)key)", False
    if t == "cubic":
        return [], f"rmi_cubic({c[0]}, {c[1]}, {c[2]}, {c[3]}, (double)key)", False
    if t in ("normal", "lognormal"):
        fn = "rmi_ncdf" if t == "normal" else "rmi_lncdf"
        return [], f"{fn}({c[0]}, {c[1]}, {c[2]}, (double)key)", False
    if t == "radix":
        return [], f"rmi_radix({c[0]}, {c[1]}, (uint64_t)key)", True
    if t == "bradix":
        fn = ("rmi_bradix_high"
              if bool(int(np.asarray(rmi.raw_top["high"]).reshape(-1)[0])) else
              "rmi_bradix_low")
        return [], f"{fn}({c[0]}, {c[1]}, {c[2]}, (uint64_t)key)", True
    if t.startswith("radix"):  # hint table
        w = np.asarray(rmi.raw_top["w_int"]).reshape(-1)
        prefix, bits = int(w[0]), int(w[1])
        shift = 0 if prefix + bits > 64 else 64 - (prefix + bits)
        return ([], f"L0_TABLE[(((uint64_t)key << {prefix}) >> {prefix}) "
                    f">> {shift}]", True)
    if t == "histogram":
        lines = [
            "  uint64_t key_radix = ((uint64_t)key) >> (64 - 20);",
            "  uint64_t radix_lb = L0_RADIX[key_radix];",
            "  uint64_t radix_ub = L0_RADIX[key_radix + 1];",
        ]
        expr = ("radix_lb + rmi_bs_upper_bound(L0_PIVOTS + radix_lb, "
                "radix_ub - radix_lb, (uint64_t)key) - 1")
        return lines, expr, True
    raise ValueError(t)


def _leaf_eval_expr(rmi, stride_fields):
    t = rmi.leaf_type
    f = [f"leaf.{name}" for name in stride_fields]
    if t in ("linear", "robust_linear", "linear_spline"):
        return f"rmi_linear({f[0]}, {f[1]}, (double)key)"
    if t == "loglinear":
        return f"rmi_loglinear({f[0]}, {f[1]}, (double)key)"
    if t == "cubic":
        return f"rmi_cubic({f[0]}, {f[1]}, {f[2]}, {f[3]}, (double)key)"
    if t in ("normal", "lognormal"):
        fn = "rmi_ncdf" if t == "normal" else "rmi_lncdf"
        return f"{fn}({f[0]}, {f[1]}, {f[2]}, (double)key)"
    raise ValueError(t)


_LEAF_FIELDS = {
    "linear": ["alpha", "beta"],
    "robust_linear": ["alpha", "beta"],
    "linear_spline": ["alpha", "beta"],
    "loglinear": ["alpha", "beta"],
    "cubic": ["a", "b", "c", "d"],
    "normal": ["mean", "stdev", "scale"],
    "lognormal": ["mean", "stdev", "scale"],
}


def generate_cpp(namespace: str, rmi, out_dir: str = ".",
                 include_errors: bool = True,
                 data_dir_name: str = "rmi_data") -> None:
    inc_err = include_errors and rmi.leaf_errors is not None
    key_c = rmi.key_type.c_type
    B = rmi.branching_factor
    n = rmi.num_rmi_rows
    size = rmi_size(rmi) if inc_err or rmi.leaf_errors is None else \
        rmi_size(rmi) - 8 * B

    consts = top_constants(rmi)
    const_names = [f"L0_PARAMETER{i}" for i in range(len(consts))]

    # radix-table LEAF layer: per-leaf [u64 prefix | u32 table | err]
    # records.  The reference cannot emit correct code for this config
    # (radix.rs:146-160 bakes one shared prefix into the emitted
    # function while prefixes are per-leaf); we emit the corrected
    # per-leaf form and document the divergence.
    table_leaf_bits = None
    if rmi.leaf_type.startswith("radix") and rmi.leaf_type not in (
            "radix", "bradix"):
        table_leaf_bits = int(rmi.leaf_type[5:])
        fields = []
        tsize = 1 << table_leaf_bits
        struct_fields = (f"  uint64_t prefix;\n"
                         f"  uint32_t table[{tsize}];\n")
    else:
        fields = _LEAF_FIELDS[rmi.leaf_type]
        struct_fields = "".join(f"  double {f};\n" for f in fields)
    if inc_err:
        struct_fields += "  uint64_t max_err;\n"

    has_cf = rmi.cache_fix is not None
    lookup_name = "_rmi_lookup_pre_cachefix" if has_cf else "lookup"
    err_param = ", size_t* err" if (inc_err or has_cf) else ""
    inner_err_param = ", size_t* err" if inc_err else ""

    # ---------------- header -----------------
    hdr = [
        "#include <cstddef>",
        "#include <cstdint>",
        f"namespace {namespace} {{",
        "bool load(char const* dataPath);",
        "void cleanup();",
        f"const size_t RMI_SIZE = {size};",
        f"const uint64_t BUILD_TIME_NS = {int(rmi.build_time)};",
        f'const char NAME[] = "{namespace}";',
        (f"uint64_t lookup(uint64_t key, size_t* err);" if has_cf else
         f"uint64_t lookup({key_c} key{err_param});"),
        "}",
        "",
    ]

    # ---------------- data header -----------------
    def dbl(val: float) -> str:
        # non-finite params arise only from degenerate fits (e.g. the
        # reference's empty-normal scale = -inf, normal.rs:29)
        if val != val:
            return "NAN"
        if val == float("inf"):
            return "INFINITY"
        if val == float("-inf"):
            return "-INFINITY"
        return repr(val)

    data_lines = [f"namespace {namespace} {{"]
    for name, (ctype, val) in zip(const_names, consts):
        if ctype == "double":
            data_lines.append(f"const double {name} = {dbl(val)};")
        else:
            data_lines.append(f"const {ctype} {name} = {val}ULL;")
    loads, frees = [], []
    if rmi.top_type == "histogram":
        nb = int(np.asarray(rmi.raw_top["count"]).reshape(-1)[0])
        rl = (1 << 20) + 1
        data_lines += ["uint64_t L0_COUNT;", "uint64_t* L0_RADIX;",
                       "uint64_t* L0_PIVOTS;"]
        loads.append(("L0", f"{namespace}_L0_PARAMETERS",
                      [("&L0_COUNT", 8, False),
                       ("L0_RADIX", rl * 8, True),
                       ("L0_PIVOTS", nb * 8, True)]))
        frees += ["L0_RADIX", "L0_PIVOTS"]
    elif rmi.top_type.startswith("radix") and rmi.top_type not in (
            "radix", "bradix"):
        tbl_bytes = get_model(rmi.top_type).bytes_per_model
        data_lines.append("uint32_t* L0_TABLE;")
        loads.append(("L0", f"{namespace}_L0_PARAMETERS",
                      [("L0_TABLE", tbl_bytes, True)]))
        frees.append("L0_TABLE")

    if table_leaf_bits is not None:
        leaf_bytes = 8 + 4 * (1 << table_leaf_bits) + (8 if inc_err else 0)
    else:
        leaf_bytes = (len(fields) + (1 if inc_err else 0)) * 8
    data_lines += [
        "struct __attribute__((packed)) LeafModel {",
        struct_fields + "};",
        "LeafModel* L1_MODELS;",
    ]
    loads.append(("L1", f"{namespace}_L1_PARAMETERS",
                  [("L1_MODELS", B * leaf_bytes, True)]))
    frees.append("L1_MODELS")

    if has_cf:
        npts = len(rmi.cache_fix[1])
        data_lines += [
            "struct __attribute__((packed)) SplinePoint {",
            "  uint64_t key; uint64_t value;", "};",
            "SplinePoint* L2_SPLINE;",
        ]
        loads.append(("L2", f"{namespace}_L2_PARAMETERS",
                      [("L2_SPLINE", npts * 16, True)]))
        frees.append("L2_SPLINE")
    data_lines += ["}", ""]

    # ---------------- cpp -----------------
    cpp = [
        f'#include "{namespace}.h"',
        f'#include "{namespace}_data.h"',
        "#include <math.h>",
        "#include <cmath>",
        "#include <cstdlib>",
        "#include <cstring>",
        "#include <fstream>",
        "#include <filesystem>",
    ]
    if has_cf:
        cpp.append("#include <algorithm>")
    cpp += [f"namespace {namespace} {{", _MATH_HELPERS]

    # load()
    cpp.append("bool load(char const* dataPath) {")
    for _tag, fname, parts in loads:
        cpp.append("  {")
        cpp.append(f"    std::ifstream infile(std::filesystem::path(dataPath)"
                   f' / "{fname}", std::ios::in | std::ios::binary);')
        cpp.append("    if (!infile.good()) return false;")
        for target, nbytes, is_malloc in parts:
            if is_malloc:
                base = target
                cpp.append(f"    {base} = decltype({base})("
                           f"malloc({nbytes}));")
                cpp.append(f"    if ({base} == nullptr) return false;")
                cpp.append(f"    infile.read((char*){base}, {nbytes});")
            else:
                cpp.append(f"    infile.read((char*)({target}), {nbytes});")
        cpp.append("    if (!infile.good()) return false;")
        cpp.append("  }")
    cpp.append("  return true;")
    cpp.append("}")

    # cleanup()
    cpp.append("void cleanup() {")
    for f in frees:
        cpp.append(f"  free({f});")
    cpp.append("}")

    # lookup()
    setup, top_expr, top_is_int = _top_eval_expr(rmi, const_names)
    mtop = get_model(rmi.top_type)
    cpp.append(f"uint64_t {lookup_name}({key_c} key{inner_err_param}) {{")
    cpp += setup
    if top_is_int:
        cpp.append(f"  uint64_t ipred = {top_expr};")
        if mtop.needs_bounds_check:
            cpp.append(f"  size_t modelIndex = ipred > {B - 1} ? {B - 1} "
                       ": (size_t)ipred;")
        else:
            cpp.append(f"  size_t modelIndex = ipred > {B - 1} ? {B - 1} "
                       ": (size_t)ipred;  // clamp kept: training clamps too "
                       "(two_layer.rs:49)")
    else:
        cpp.append(f"  double tpred = {top_expr};")
        cpp.append(f"  size_t modelIndex = FCLAMP(tpred, {B}.0 - 1.0);")
    cpp.append("  const LeafModel& leaf = L1_MODELS[modelIndex];")
    if table_leaf_bits is not None:
        bits = table_leaf_bits
        cpp += [
            "  uint64_t p = leaf.prefix;",
            "  uint64_t low = p >= 64 ? 0 : (((uint64_t)key << p) >> p);",
            f"  uint64_t sh = (p + {bits} > 64) ? 0 : 64 - p - {bits};",
            "  uint64_t ipred2 = leaf.table[low >> sh];",
        ]
        if inc_err:
            cpp.append("  *err = leaf.max_err;")
        cpp.append(f"  return ipred2 > {n - 1}ULL ? {n - 1}ULL : ipred2;")
    else:
        cpp.append(f"  double fpred = {_leaf_eval_expr(rmi, fields)};")
        if inc_err:
            cpp.append("  *err = leaf.max_err;")
        cpp.append(f"  return FCLAMP(fpred, {n}.0 - 1.0);")
    cpp.append("}")

    if has_cf:
        line_size = rmi.cache_fix[0]
        npts = len(rmi.cache_fix[1])
        total = rmi.num_data_rows
        cpp.append(f"""
uint64_t lookup(uint64_t key, size_t* err) {{
  const uint64_t num_spline_pts = {npts};
  size_t spline_err;
  *err = {line_size};
  uint64_t start = _rmi_lookup_pre_cachefix(key{', &spline_err' if inc_err else ''});
  {'' if inc_err else 'spline_err = num_spline_pts;'}
  size_t upper = start + spline_err > num_spline_pts ? num_spline_pts
                                                     : start + spline_err;
  size_t lower = spline_err > start ? 0 : start - spline_err;
  SplinePoint* begin = L2_SPLINE;
  SplinePoint* res = std::lower_bound(
      begin + lower, begin + upper, key,
      [](const SplinePoint& lhs, const uint64_t rhs) {{
        return lhs.key < rhs;
      }});
  if (res == begin + num_spline_pts) return {total} - 1;
  if (res == begin) res = begin + 1;
  SplinePoint pt1 = *(res - 1);
  SplinePoint pt2 = *res;
  double v0 = (double)pt1.value, v1 = (double)pt2.value;
  double t = ((double)(key - pt1.key)) / (double)(pt2.key - pt1.key);
  return (((uint64_t)std::fma(1.0 - t, v0, t * v1)) / {line_size}) * {line_size};
}}""")

    cpp.append("}  // namespace")
    cpp.append("")

    with open(os.path.join(out_dir, f"{namespace}.h"), "w") as f:
        f.write("\n".join(hdr))
    with open(os.path.join(out_dir, f"{namespace}_data.h"), "w") as f:
        f.write("\n".join(data_lines))
    with open(os.path.join(out_dir, f"{namespace}.cpp"), "w") as f:
        f.write("\n".join(cpp))
