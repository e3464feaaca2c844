"""A pass's ResNet18 FLOPs (every row, from shapes) over the run's median
untraced pass, as a share of the card's float32 peak (the pass runs with
TF32 off), in %."""
from portbench.core import flops as FL
from portbench.core.work import peaks, untraced_unit_s


def read(run):
    unit_s = untraced_unit_s(run)
    if run.kind != "prefilter" or not unit_s:
        return None
    size = run.config["model"]["image_size"]
    return 100.0 * run.n * FL.resnet18_flops(size) / unit_s / peaks(run)["f32_flops"]
