"""Set-up seconds: from the process's start (imports included) to the
window's: inputs and weights made on the card, the kernels' build (in a
fresh checkout), the program's set-up and the warm-up unit."""


def read(run):
    return run.setup_s
