"""The port's configs, command line, checkpoints and parity report against
the JAX package (CPU, small size).

* Presets: the port's are the JAX package's, field for field (the same
  JSON); a config JSON written by either package loads in the other.
* Checkpoint: saved after epoch 1 and restored into a fresh Trainer, the
  run's epochs 2-3 (the first loss strain at 3) give the masks, losses and
  weights of the uninterrupted run exactly; restoring an earlier epoch
  reads that epoch's metadata; the metadata keys are the JAX package's.
* CLI: ``--list``, a tiny ``basic`` run with ``--device cpu --out``, a
  resumed run, and ``--dp`` / ``--eval`` exiting with code 2.
* Parity report: ``agreement_report`` gives the JAX module's dict on the
  same scores and masks, for every method the port runs; the port's oracle
  copy gives the JAX oracle's values (exactly: the same numpy code).
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from strainer_gan_tpu import config as JC
from strainer_gan_tpu.parity import agreement as JAG, oracle as JOR

from strainer_gan_tpu_torch import cli, config as PC
from strainer_gan_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from strainer_gan_tpu_torch.obs import images as IM
from strainer_gan_tpu_torch.parity import agreement as PAG, oracle as POR
from strainer_gan_tpu_torch.train.loop import Trainer

# the keys of `strainer_gan_tpu/checkpoint.py:55-66`
JAX_META_KEYS = {"epoch", "d_bn_eval", "iters", "has_ae", "has_last_mask",
                 "has_last_scores", "last_threshold", "band_cooloff"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes: one intra-op thread each, so parallel test workers do
    not oversubscribe the cores (torch's thread pool spins while it waits)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(PC.PRESETS))
def test_presets_and_json_match_jax(name):
    port, ref = PC.get_preset(name), JC.get_preset(name)
    assert port.to_json() == ref.to_json()
    assert PC.ExperimentConfig.from_json(ref.to_json()) == port
    assert JC.ExperimentConfig.from_json(port.to_json()) == ref
    if name == "final":
        assert port.strain.score_precision == "band_bf16"


def test_custom_config_json_crosses_packages():
    cfg = PC.get_preset("zscore_loss")
    cfg = cfg.replace(name="custom", strain=dataclasses.replace(
        cfg.strain, clean_ratio_schedule=((0, 1.0), (2, 0.7)), band_eps=0.1),
        train=dataclasses.replace(cfg.train, epochs=3, check_finite=True))
    ref = JC.ExperimentConfig.from_json(cfg.to_json())
    assert ref.strain.clean_ratio_schedule == ((0, 1.0), (2, 0.7))
    assert PC.ExperimentConfig.from_json(ref.to_json()) == cfg


def _tiny_final(epochs=4, **strain):
    cfg = PC.get_preset("final")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=8),
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8),
        train=dataclasses.replace(cfg.train, epochs=epochs, log_every=0, sample_every=0),
        strain=dataclasses.replace(cfg.strain, score_batch=16, **strain),
    )


def _state(tr):
    return {k: v.clone() for k, v in list(tr.gen.state_dict().items())
            + list(tr.disc.state_dict().items())}


def test_resume_equals_the_uninterrupted_run(tmp_path):
    cfg = _tiny_final()
    straight = Trainer(cfg, device="cpu", max_synth=32)
    straight.setup()
    for e in range(2):
        straight.run_epoch(e)
    save_checkpoint(str(tmp_path / "ck"), straight, epoch=1)
    iters_1 = straight._iters
    rest = [straight.run_epoch(e) for e in (2, 3)]

    resumed = Trainer(cfg, device="cpu", max_synth=32)
    resumed.setup()
    assert restore_checkpoint(str(tmp_path / "ck"), resumed) == 2
    assert resumed._iters == iters_1
    again = [resumed.run_epoch(e) for e in (2, 3)]
    for a, b in zip(straight.mask_history[2:], resumed.mask_history):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(straight.epoch_loss_history[2:], resumed.epoch_loss_history):
        np.testing.assert_array_equal(a, b)
    assert [o["steps"] for o in rest] == [o["steps"] for o in again]
    assert resumed.mask_history[1].sum() < resumed.mask_history[0].sum()  # epoch 3 strained
    assert torch.equal(resumed.engine.last_scores, straight.engine.last_scores)
    assert float(resumed.engine.last_threshold) == float(straight.engine.last_threshold)
    want = _state(straight)
    for k, v in _state(resumed).items():
        assert torch.equal(v, want[k]), k
    assert resumed._iters == straight._iters


def test_restore_earlier_epoch_uses_its_metadata(tmp_path):
    """`tests/test_resume_strain.py:137`: a pre-strain epoch and a
    post-strain epoch in one directory; each restores with its own meta."""
    cfg = _tiny_final(start_epoch=1, prefilter=False)
    tr = Trainer(cfg, device="cpu", max_synth=32)
    tr.setup()
    tr.run_epoch(0)
    assert tr.engine.last_mask is None
    iters_e0 = tr._iters
    save_checkpoint(str(tmp_path / "ck"), tr, epoch=0)
    tr.run_epoch(1)
    assert tr.engine.last_scores is not None
    save_checkpoint(str(tmp_path / "ck"), tr, epoch=1)
    for name in ("meta.json", "meta_epoch_0.json", "meta_epoch_1.json"):
        with open(tmp_path / "ck" / name) as f:
            assert set(json.load(f)) == JAX_META_KEYS
    with open(tmp_path / "ck" / "config.json") as f:
        assert JC.ExperimentConfig.from_json(f.read()).to_json() == cfg.to_json()

    r1 = Trainer(cfg, device="cpu", max_synth=32)
    r1.setup()
    assert restore_checkpoint(str(tmp_path / "ck"), r1) == 2
    assert torch.equal(r1.engine.last_mask, tr.engine.last_mask)
    assert r1.engine.d_bn_eval and r1._iters == tr._iters

    r0 = Trainer(cfg, device="cpu", max_synth=32)
    r0.setup()
    assert restore_checkpoint(str(tmp_path / "ck"), r0, epoch=0) == 1
    assert r0.engine.last_mask is None and r0.engine.last_scores is None
    assert r0.engine.last_threshold is None and not r0.engine.d_bn_eval
    assert r0._iters == iters_e0


def test_cli_list(capsys):
    assert cli.main(["--list"]) == 0
    text = capsys.readouterr().out
    for name in PC.PRESETS:
        assert name in text
    assert "strain=loss_percentile" in text


@pytest.mark.parametrize("flag", [["--dp", "100000"], ["--preset", "mnist8", "--eval"],
                                  ["--preset", "nope"],
                                  ["--config", "/nonexistent.json"]])
def test_cli_refuses_with_code_2(flag, capsys):
    assert cli.main(flag + ["--device", "cpu"]) == 2
    assert "error:" in capsys.readouterr().err


def test_cli_runs_and_resumes_basic(tmp_path, capsys):
    out = tmp_path / "run"
    args = ["--preset", "basic", "--device", "cpu", "--max-synth", "24", "--batch-size", "8",
            "--epochs", "2", "--out", str(out), "--checkpoint-every", "1",
            "--save-samples-every", "1", "--parity-check"]
    tr, results = cli.run(args)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out / "metrics.json") as f:
        assert json.load(f) == printed
    assert printed["epochs"] == 2 and printed["parity"] == {}
    assert printed["summary"]["steps"] == 6 and np.isfinite(printed["summary"]["last_D_loss"])
    png = (out / "samples.png").read_bytes()
    assert png == IM.encode_png(IM.make_grid(tr.sample(64)))
    assert (out / "samples_epoch2.png").exists() and (out / "ckpt" / "epoch_1").is_dir()
    # one more epoch from the checkpoint of epoch 1
    tr2, res2 = cli.run(args[:-7] + ["--epochs", "3", "--resume", str(out / "ckpt")])
    assert res2["epochs"] == 1 and tr2._iters == 9


def test_cli_describe(capsys):
    tr, results = cli.run(["--preset", "basic", "--device", "cpu", "--max-synth", "8",
                           "--describe"])
    text = capsys.readouterr().out
    assert results == {} and "G: params=3,576,704" in text and "float32" in text


def _jax_trainer(method, strain, engine):
    cfg = JC.get_preset("final" if method == "loss_percentile" else "zscore")
    cfg = cfg.replace(strain=dataclasses.replace(cfg.strain, method=method, **strain))
    return types.SimpleNamespace(cfg=cfg, engine=types.SimpleNamespace(**engine))


@pytest.mark.parametrize("method,strain", [
    ("none", {}), ("zscore_fixed", {}), ("zscore_fixed", {"strict_less": False}),
    ("zscore_elbow", {}), ("zscore_dbscan", {"dbscan_eps": 3.0}),
    ("loss_percentile", {}), ("loss_percentile", {"final_py_ratio_inversion": False}),
])
def test_agreement_report_matches_jax(method, strain):
    rng = np.random.default_rng(11)
    n = 300
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    feats[:, 3] = 1.0  # a dead column, which the report tags
    scores = np.abs(rng.standard_normal(n)).astype(np.float32) * 3
    base = rng.random(n) > 0.2
    mask = (scores < 2.5) & base
    mask[:5] = ~mask[:5]  # a few disagreements
    if method == "loss_percentile":
        scores[~base] = np.inf
    engine = dict(last_scores=scores, last_mask=mask, base_active=base, _features=feats)
    jt = _jax_trainer(method, strain, engine)
    pt = types.SimpleNamespace(cfg=PC.ExperimentConfig.from_json(jt.cfg.to_json()),
                               engine=types.SimpleNamespace(
                                   **{k: torch.from_numpy(v) for k, v in engine.items()}))
    want = JAG.agreement_report(jt, epoch=3)
    got = PAG.agreement_report(pt, epoch=3)
    assert got == want
    assert bool(got) == (method != "none")


def test_agreement_report_before_any_strain():
    pt = types.SimpleNamespace(cfg=PC.get_preset("final"), engine=types.SimpleNamespace(
        last_scores=None, last_mask=None))
    assert PAG.agreement_report(pt) == {}


@pytest.mark.parametrize("name,args", [
    ("max_abs_zscores_torch", ("feats",)), ("max_abs_zscores_numpy", ("feats",)),
    ("zscore_fixed_mask", ("feats",)), ("find_elbow_threshold", ("scores",)),
    ("zscore_elbow_mask", ("feats",)), ("dbscan_clean_ratio", ("feats", 3.0)),
    ("zscore_quantile_mask", ("feats", 0.8)), ("bce_losses", ("probs", 1.0)),
    ("percentile_refine_mask", ("scores", 0.3)), ("batch_quantile_keep", ("scores",)),
    ("ae_error_mask", ("scores",)), ("gmm_mask", ("scores",)),
    ("ensemble_truncated_indices", ("scores", 0.8)),
])
def test_oracle_copy_matches_jax(name, args):
    rng = np.random.default_rng(5)
    data = dict(feats=rng.standard_normal((200, 6)).astype(np.float32),
                scores=np.concatenate([rng.normal(1, 0.2, 150), rng.normal(3, 0.3, 50)]),
                probs=rng.uniform(0, 1, 200).astype(np.float32))
    call = [data[a] if isinstance(a, str) else a for a in args]
    got, want = getattr(POR, name)(*call), getattr(JOR, name)(*call)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)
