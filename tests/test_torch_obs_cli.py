"""The port's profiler module and the new presets through its command line
(CPU).

* ``obs/profiler.trace`` writes a Chrome trace of the enclosed block and
  ``summarize`` reads it (on the CPU there are no device operations, so the
  busy share is 0; on the card ``chip_smoke.py`` prints it);
  ``debug_nans`` raises on a NaN gradient and restores the mode.
* ``batch_mask``, ``loss_gmm``, ``loss_ensemble`` and ``autoencoder`` run
  through ``python -m strainer_gan_tpu_torch.cli`` on the CPU at a small
  size, with the parity report, and ``--list`` shows them.
* ``log_contamination`` prints the JAX package's line letter for letter.
"""
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from strainer_gan_tpu.obs.metrics import MetricsLogger as JLogger

from strainer_gan_tpu_torch import cli, get_preset
from strainer_gan_tpu_torch.obs import profiler
from strainer_gan_tpu_torch.obs.metrics import MetricsLogger


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trace_and_summary(tmp_path):
    a = torch.randn(64, 64)
    with profiler.trace(str(tmp_path)) as prof:
        for _ in range(3):
            a = torch.tanh(a @ a)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    s = profiler.summarize(prof, steps=3)
    assert s["wall_ms"] > 0 and s["device_busy_ms"] == 0.0 and s["busy_share"] == 0.0
    assert s["top"] == [] and s["launches_per_step"] == 0.0


def test_debug_nans_raises_and_restores():
    x = torch.tensor([-1.0], requires_grad=True)
    before = torch.is_anomaly_enabled()
    with pytest.raises(RuntimeError, match="nan"):
        with profiler.debug_nans():
            torch.sqrt(x).sum().backward()
    assert torch.is_anomaly_enabled() == before


def test_contamination_line_is_the_jax_text():
    ours, theirs = io.StringIO(), io.StringIO()
    MetricsLogger(stream=ours).log_contamination(10, 3, 41)
    JLogger(stream=theirs).log_contamination(10, 3, 41)
    assert ours.getvalue() == theirs.getvalue() == "Epoch 10: Filtered CIFAR-10 images: 3/41\n"


def test_cli_lists_the_new_presets(capsys):
    assert cli.main(["--list"]) == 0
    text = capsys.readouterr().out
    for name, method in (("batch_mask", "batch_quantile_mask"), ("loss_gmm", "loss_gmm"),
                         ("loss_ensemble", "loss_ensemble"), ("autoencoder", "autoencoder")):
        assert any(ln.startswith(name + " ") and f"strain={method}" in ln
                   for ln in text.splitlines())


@pytest.mark.parametrize("name", ["batch_mask", "loss_gmm", "loss_ensemble", "autoencoder"])
def test_cli_runs_the_new_presets(name, tmp_path, capsys):
    """The preset at narrow widths (a config JSON), through the CLI; the
    in-step mask gated from epoch 2 so that four epochs reach it."""
    cfg = get_preset(name)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, ngf=8, ndf=8),
                      strain=dataclasses.replace(cfg.strain, mask_start_epoch=2))
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    args = ["--config", str(tmp_path / "cfg.json"), "--device", "cpu", "--max-synth", "32",
            "--batch-size", "16", "--epochs", "4", "--parity-check", "--out", str(tmp_path),
            "--checkpoint-every", "4"]
    tr, results = cli.run(args)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == results and results["epochs"] == 4
    assert np.isfinite(results["summary"]["last_D_loss"])
    method = tr.cfg.strain.method
    assert results["parity"]["method"] == method
    if method in ("batch_quantile_mask", "autoencoder"):
        assert results["parity"]["agreement"] == 1.0
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["has_ae"] == (name == "autoencoder")
    assert os.path.exists(tmp_path / "samples.png")
