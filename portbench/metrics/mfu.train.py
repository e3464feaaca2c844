"""The traced epoch's model FLOPs (steps at the full batch and the
strain's D forwards, from shapes) over the run's median untraced epoch
(every epoch does the same work), as a share of the card's bfloat16
peak, in %."""
from portbench.core.work import peaks, train_unit_flops, untraced_unit_s


def read(run):
    unit_s = untraced_unit_s(run)
    if run.kind != "epoch" or not unit_s or not run.traced.get("steps"):
        return None
    return 100.0 * train_unit_flops(run) / unit_s / peaks(run)["bf16_flops"]
