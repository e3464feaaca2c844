"""K1 (``bce_scores_kernel``): the least time its bytes need at the card's
bandwidth (each logit read once, each loss written once: 8 bytes an
element, over the elements of the traced strain events) over its traced
device time, in %."""
from portbench.core import flops as FL
from portbench.core.work import k1_elements, peaks


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel_seconds(["bce_scores_kernel"])
    n = k1_elements(run.traced.get("engine", {}))
    if not launches or not n or seconds <= 0:
        return None
    return 100.0 * FL.k1_bytes(n) / peaks(run)["hbm_bytes_per_s"] / seconds
