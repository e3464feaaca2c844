"""Steps run as CUDA graph replays over all steps the window ran, in %
(the program's ``graph_stats["replays"]`` times the chunk, over the
epochs' ``steps``)."""


def read(run):
    if run.kind != "epoch":
        return None
    steps = sum(u["steps"] for u in run.window["units"])
    if not steps:
        return None
    return 100.0 * run.window["replays"] * run.window["chunk"] / steps
