"""On the card: the control (the reference in the program's place, one
precision below the configuration's) and each of the judge's planted
faults fail the committed limits of every cell, at a size a test run can
hold (a tenth to a twentieth of the cell's images); a sound run passes.
And the chunk's faults planted in the program's captured graph (its
optimizer steps left out; every step on its first step's rows and noise)
come out not correct in both training cells.  Run with
``python -m pytest portbench/tests -q -m cuda`` on a machine with the
card; skips elsewhere."""
import pytest
import torch

from portbench import calibrate as CB
from portbench.core import checks as C
from portbench.core import drivers, spec
from test_portbench_faults import CHUNK_FAULTS

SIZES = {"final.strain_epoch": 30_000, "batch_mask.masked_epoch": 11_100,
         "final.prefilter": 12_600}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_and_faults_fail(card, workload):
    cell = spec.load_cell(workload)
    run = drivers.Run(cell, 424242, card, scale=dict(n_images=SIZES[workload], batch_size=128))
    run.setup()
    if run.kind == "prefilter":
        run.run_window(0.0)
    run.trainer.drop_captures()
    res = CB.readings_for(run, controls=True)
    run.close()
    assert C.decide(res.pop("program"), cell.limits)[0]
    for name, nums in res.items():
        assert not C.decide(nums, cell.limits)[0], (name, nums)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["batch_mask.masked_epoch", "final.strain_epoch"])
@pytest.mark.parametrize("fault", sorted(CHUNK_FAULTS))
def test_chunk_faults_in_the_graph_fail(card, monkeypatch, workload, fault):
    from strainer_gan_tpu_torch.train import steps as S

    monkeypatch.setattr(S.ChunkedStep, "_body", CHUNK_FAULTS[fault](S.ChunkedStep._body))
    cell = spec.load_cell(workload)
    run = drivers.Run(cell, 424243, card, scale=dict(n_images=SIZES[workload], batch_size=128))
    run.setup()
    assert run.trainer.graph_stats["replays"] > 0, "the checked epoch replayed no chunk"
    run.trainer.drop_captures()
    nums = C.readings(run)
    run.close()
    assert not C.decide(nums, cell.limits)[0], nums
