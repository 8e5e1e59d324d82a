// The C entry points of the kernel library, one RMI_ENTRY(name, (params))
// each.  Every entry launches on the stream it is handed (its last
// parameter) and returns cudaGetLastError(), or a CUDA error code for
// arguments it refuses.
//
// Three readers expand the list: common.cuh declares each entry (so a
// definition in a .cu file that differs from its line here does not
// compile), binding.cpp makes its Python binding from each prototype,
// and ops/_build.py reads the names and parameter types (SIGNATURES).
// Keep one entry per RMI_ENTRY and its parameters in one parenthesis.
#include <stdint.h>

// K1, FixDups and its shard form (csrc/scan.cu)
RMI_ENTRY(rmi_scan_i32, (const int32_t* v, int32_t* out, int64_t n, int32_t is_max,
                         int32_t fill, int32_t reverse, int32_t* scratch, void* stream))
RMI_ENTRY(rmi_fixdups, (const int64_t* keys, int32_t* out, int64_t n, void* stream))
RMI_ENTRY(rmi_fixdups_carry, (const int64_t* keys, int32_t* out, int64_t n, int64_t offset,
                              const int64_t* first, void* stream))
// K2, the leaf fits' moments and their first pass alone (csrc/moments.cu)
RMI_ENTRY(rmi_aug_moments, (const double* x, const double* y, const int32_t* y_targets,
                            const double* mean_x, const double* mean_y,
                            const int64_t* aug_starts, const int64_t* aug_ends, double* m2,
                            double* c, int64_t B, void* stream))
RMI_ENTRY(rmi_aug_moments_weighted, (const double* x, const double* y, const double* w,
                                     const int32_t* y_targets,
                                     const double* mean_x, const double* mean_y,
                                     const int64_t* aug_starts, const int64_t* aug_ends,
                                     double* m2, double* c, int64_t B, void* stream))
RMI_ENTRY(rmi_aug_moments_xx, (const double* x, const double* mean_x,
                               const int64_t* aug_starts, const int64_t* aug_ends,
                               double* m2, int64_t B, void* stream))
RMI_ENTRY(rmi_aug_fit_moments, (const double* x, const int32_t* y, const int64_t* aug_starts,
                                const int64_t* aug_ends, int64_t n, int64_t xx_only,
                                double* out, int64_t B, int64_t* scratch, int64_t capacity,
                                void* stream))
RMI_ENTRY(rmi_aug_fit_log_moments, (const double* x, const int32_t* y,
                                    const int64_t* aug_starts, const int64_t* aug_ends,
                                    int64_t n, double* out, int64_t B, int64_t* scratch,
                                    int64_t capacity, void* stream))
RMI_ENTRY(rmi_aug_fit_sums, (const double* x, const int32_t* y, const int64_t* aug_starts,
                             const int64_t* aug_ends, int64_t form, double* out, int64_t B,
                             int64_t* scratch, int64_t capacity, void* stream))
// K3 (csrc/sweep.cu)
RMI_ENTRY(rmi_sweep_max_linear, (const double* xn, const int32_t* yfix,
                                 const int64_t* starts, const int64_t* ends,
                                 const double* w, int32_t* max_err, int64_t B,
                                 int64_t n_keys, int64_t bound, void* stream))
RMI_ENTRY(rmi_sweep_max_cubic, (const double* xn, const int32_t* yfix,
                                const int64_t* starts, const int64_t* ends,
                                const double* w, int32_t* max_err, int64_t B,
                                int64_t n_keys, int64_t bound, void* stream))
RMI_ENTRY(rmi_sweep_max_loglinear, (const double* xn, const int32_t* yfix,
                                    const int64_t* starts, const int64_t* ends,
                                    const double* w, int32_t* max_err, int64_t B,
                                    int64_t n_keys, int64_t bound, void* stream))
RMI_ENTRY(rmi_sweep_max_normal, (const double* xn, const int32_t* yfix,
                                 const int64_t* starts, const int64_t* ends,
                                 const double* w, int32_t* max_err, int64_t B,
                                 int64_t n_keys, int64_t bound, void* stream))
// the run-length pass and its shard form (csrc/run_max.cu)
RMI_ENTRY(rmi_span_run_max, (const int64_t* keys, const int32_t* yfix,
                             const int64_t* starts, const int64_t* ends,
                             int32_t* longest_run, int64_t B, int64_t n, void* stream))
RMI_ENTRY(rmi_span_run_max_carry, (const int64_t* keys, const int32_t* yfix,
                                   const int64_t* starts, const int64_t* ends,
                                   int32_t* longest_run, int64_t B, int64_t n, int64_t offset,
                                   int64_t total, const int64_t* last_end, void* stream))
// K4, per element and lookup whole (csrc/eval.cu)
RMI_ENTRY(rmi_leaf_eval_linear, (const double* x, const double* w, const int64_t* leaf,
                                 int32_t* out, int64_t m, int64_t bound, void* stream))
RMI_ENTRY(rmi_leaf_eval_cubic, (const double* x, const double* w, const int64_t* leaf,
                                int32_t* out, int64_t m, int64_t bound, void* stream))
RMI_ENTRY(rmi_leaf_eval_loglinear, (const double* x, const double* w,
                                    const int64_t* leaf, int32_t* out, int64_t m,
                                    int64_t bound, void* stream))
RMI_ENTRY(rmi_leaf_eval_normal, (const double* x, const double* w, const int64_t* leaf,
                                 int32_t* out, int64_t m, int64_t bound, void* stream))
RMI_ENTRY(rmi_lookup_linear, (const int64_t* keys, int64_t key_kind, const double* top_w,
                              int64_t top_kind, const int64_t* top_int, const int32_t* top_table,
                              const int64_t* pivots, int64_t top_len, int64_t route,
                              const double* rows, int64_t* guess, int64_t* err, int64_t m,
                              int64_t B, int64_t n, double offset, double scale, void* stream))
RMI_ENTRY(rmi_lookup_cubic, (const int64_t* keys, int64_t key_kind, const double* top_w,
                             int64_t top_kind, const int64_t* top_int, const int32_t* top_table,
                             const int64_t* pivots, int64_t top_len, int64_t route,
                             const double* rows, int64_t* guess, int64_t* err, int64_t m,
                             int64_t B, int64_t n, double offset, double scale, void* stream))
RMI_ENTRY(rmi_lookup_loglinear, (const int64_t* keys, int64_t key_kind, const double* top_w,
                                 int64_t top_kind, const int64_t* top_int, const int32_t* top_table,
                                 const int64_t* pivots, int64_t top_len, int64_t route,
                                 const double* rows, int64_t* guess, int64_t* err, int64_t m,
                                 int64_t B, int64_t n, double offset, double scale, void* stream))
RMI_ENTRY(rmi_lookup_normal, (const int64_t* keys, int64_t key_kind, const double* top_w,
                              int64_t top_kind, const int64_t* top_int, const int32_t* top_table,
                              const int64_t* pivots, int64_t top_len, int64_t route,
                              const double* rows, int64_t* guess, int64_t* err, int64_t m,
                              int64_t B, int64_t n, double offset, double scale, void* stream))
// K6 (csrc/cubic_l1.cu)
RMI_ENTRY(rmi_cubic_l1, (const double* x, const int32_t* y, const double* cubic_w,
                         const double* lin_w, const int64_t* aug_starts,
                         const int64_t* aug_ends, double* c_err, double* l_err,
                         int64_t B, void* stream))
// K5 (csrc/sorted_serve.cu)
RMI_ENTRY(rmi_serve_sorted, (const int64_t* q, int64_t nq, const int64_t* group_first,
                             int64_t ng, const int64_t* keys, int64_t n,
                             const int64_t* lo_b, const int64_t* hi_b, int64_t kq,
                             int64_t group, int64_t* out, void* stream))
RMI_ENTRY(rmi_serve_sorted_scatter, (const int64_t* q, const int64_t* order, int64_t nq,
                                     const int64_t* group_first, int64_t ng,
                                     const int64_t* keys, int64_t n, const int64_t* lo_b,
                                     const int64_t* hi_b, int64_t kq, int64_t group,
                                     int64_t* out, void* stream))
// the hierarchical plan's resolve (csrc/hier.cu)
RMI_ENTRY(rmi_hier_resolve, (const int64_t* queries, const int64_t* guess, const int64_t* err,
                             const int64_t* keys, int64_t n0, const int64_t* upper,
                             const int64_t* index, int64_t K, int64_t* out, int64_t m,
                             int64_t n, void* stream))
// the cachefix serving path (csrc/cachefix.cu)
RMI_ENTRY(rmi_bounded_lower_bound, (const int64_t* keys, int64_t n_keys, const int64_t* queries,
                                    const int64_t* guess, const int64_t* err, int64_t* out,
                                    int64_t m, int64_t n, int64_t iters, int64_t exact,
                                    void* stream))
RMI_ENTRY(rmi_cachefix_interp, (const int64_t* knots, const int64_t* vals, int64_t num_pts,
                                const int64_t* sample, int64_t n_sample, int64_t sample_stride,
                                const int64_t* queries, const int64_t* start,
                                const int64_t* err, int64_t* out, int64_t m,
                                int64_t line_size, int64_t total_keys, double eps,
                                int64_t iters, void* stream))
// the packed plan's search and K5's window bounds (csrc/packed.cu)
RMI_ENTRY(rmi_packed_search, (const int64_t* queries, int64_t key_kind, const double* top_w,
                              int64_t top_kind, const int64_t* top_int,
                              const int32_t* top_table, const int64_t* pivots,
                              int64_t top_len, int64_t route, const int64_t* leaf_ids,
                              const int64_t* rows, const int64_t* bases, int64_t S, int64_t F,
                              const int64_t* stripe_first, const int64_t* keys, int64_t* out,
                              int64_t m, int64_t B, int64_t n, double offset, double scale,
                              int64_t kmin, int64_t kmax, void* stream))
RMI_ENTRY(rmi_sorted_bounds, (const int64_t* queries, int64_t key_kind, const double* top_w,
                              int64_t top_kind, const int64_t* top_int,
                              const int32_t* top_table, const int64_t* pivots,
                              int64_t top_len, int64_t route, const int64_t* leaf_ids,
                              const int64_t* rows, const int64_t* bases, int64_t S, int64_t F,
                              int64_t* lo, int64_t* hi, int64_t nq, int64_t kq, int64_t B,
                              int64_t n, double offset, double scale, int64_t kmin, int64_t kmax,
                              void* stream))
// stage A of the build: the normalized keys, the cubic top's fit, the
// leaf assignment (csrc/top.cu)
RMI_ENTRY(rmi_key_normalize, (const int64_t* keys, int64_t key_kind, double* x, int64_t n,
                              double offset, double scale, void* stream))
RMI_ENTRY(rmi_top_cubic_candidates, (const double* x, const int32_t* y, const int64_t* keys,
                                     int64_t key_kind, int64_t n, double sf,
                                     int64_t scale_targets, int64_t has_ep, double ep_first,
                                     double ep_last, double* cand, void* stream))
RMI_ENTRY(rmi_top_l1_cubic, (const double* x, const int32_t* y, int64_t n, double sf,
                             int64_t scale_targets, const double* cand, double* partials,
                             int64_t capacity, double* sums, double* row, int32_t* top_case,
                             void* stream))
RMI_ENTRY(rmi_top_l1_partial, (const double* x, const int32_t* y, int64_t n, double sf,
                               int64_t scale_targets, const double* cand, double* partials,
                               int64_t capacity, double* sums, void* stream))
// stage A's other top fits: the linear-family and normal tops' moments and
// the hint-table tops (csrc/top_fit.cu)
RMI_ENTRY(rmi_top_moments, (const double* x, const int32_t* y, int64_t n, int64_t lo,
                            int64_t hi, double sf, int64_t scale_targets, int64_t model,
                            double* scratch, int64_t capacity, double* row, void* stream))
RMI_ENTRY(rmi_top_table_fit, (const int64_t* images, const int32_t* y, int64_t n, double sf,
                              int64_t scale_targets, int64_t bits, int32_t* table,
                              int64_t* w_int, void* stream))
RMI_ENTRY(rmi_top_assign, (const double* x, const int64_t* images, const double* top_w,
                           int64_t top_kind, const int64_t* top_int,
                           const int32_t* top_table, const int64_t* pivots, int64_t top_len,
                           int32_t* t, int64_t n, int64_t B, void* stream))
// the card probes (csrc/probes.cu)
RMI_ENTRY(rmi_probe_scale2, (const float* x, float* out, int64_t n, void* stream))
RMI_ENTRY(rmi_probe_lt_i64, (const int64_t* x, const int64_t* q, int32_t* out, int64_t n,
                             void* stream))
RMI_ENTRY(rmi_probe_lt_u64, (const int64_t* x, const int64_t* q, int32_t* out, int64_t n,
                             void* stream))
RMI_ENTRY(rmi_probe_lt_u32pair, (const int32_t* hi, const int32_t* lo, const int32_t* qh,
                                 const int32_t* ql, int32_t* out, int64_t n,
                                 void* stream))
RMI_ENTRY(rmi_probe_gather_rows, (const float* tbl, const int32_t* idx, float* out,
                                  int64_t nrows, int64_t width, int64_t nq,
                                  void* stream))
RMI_ENTRY(rmi_probe_take, (const float* tbl, const int32_t* idx, float* out,
                           int64_t ntbl, int64_t nq, void* stream))
RMI_ENTRY(rmi_probe_take_lanes, (const float* tbl, const int32_t* idx, float* out,
                                 int64_t rows, int64_t width, void* stream))
RMI_ENTRY(rmi_probe_row_ring, (const float* tbl, int64_t nrows, int64_t width,
                               int64_t fetches, int64_t slots, int64_t blocks,
                               int64_t warps, float* out, void* stream))
RMI_ENTRY(rmi_probe_row_copy, (const int32_t* idx, const float* x, float* out,
                               int64_t width, int64_t nq, void* stream))
