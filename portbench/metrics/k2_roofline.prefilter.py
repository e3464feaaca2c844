"""K2a (``col_welford_kernel``, ``col_finish_kernel``) and K2b
(``row_max_*_kernel``) together: the least time their bytes need at the
card's bandwidth (the (N, 512) float32 features read once by each, the
statistics and the scores written once) over their summed traced device
time, in %."""
from portbench.core import flops as FL
from portbench.core.work import peaks

FEATURE_DIM = 512


def read(run):
    if run.trace is None or run.kind != "prefilter":
        return None
    seconds, launches = run.trace.kernel_seconds(["col_welford_kernel", "col_finish_kernel",
                                                  "row_max_vec_kernel", "row_max_scalar_kernel"])
    if not launches or seconds <= 0:
        return None
    total = FL.k2a_bytes(run.n, FEATURE_DIM) + FL.k2b_bytes(run.n, FEATURE_DIM)
    return 100.0 * total / peaks(run)["hbm_bytes_per_s"] / seconds
