"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a small size, once for each fault a cell can have (one card: no exchange
between chips to leave out).  The chunk's faults are planted in the
replayed chunk alone (``ChunkedStep._body``, which the card captures as a
CUDA graph and the CPU runs eagerly), so the eager steps stay sound."""
import time

import pytest
import torch

from portbench.run import run_cell
from test_portbench_reference import SMALL


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def _run(workload):
    n, bs = SMALL[workload]
    result, rows = run_cell(workload, 20261, 0.5, False, device="cpu",
                            scale=dict(n_images=n, batch_size=bs),
                            setup_clock=time.perf_counter())
    return result["correct"], rows


def _unchanged(orig):
    """A step that returns its state unchanged."""
    def step(gen, disc, opt_g, opt_d, *a, **kw):
        keep = [t.detach().clone() for m in (gen, disc) for t in m.state_dict().values()]
        opt = [(o, {p: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                    for p, s in o.state.items()}) for o in (opt_g, opt_d)]
        out = orig(gen, disc, opt_g, opt_d, *a, **kw)
        with torch.no_grad():
            for t, k in zip([t for m in (gen, disc) for t in m.state_dict().values()], keep):
                t.copy_(k)
        for o, saved in opt:
            o.state.clear()
            o.state.update(saved)
        return out
    return step


def _half_batch(orig):
    """Half of the batch left out, the mean taken over the rest."""
    def step(gen, disc, opt_g, opt_d, x, *a, **kw):
        if kw.get("lane_count") is None:
            kw["lane_count"] = x.shape[0] // 2
        return orig(gen, disc, opt_g, opt_d, x, *a, **kw)
    return step


def _unchanged_chunk(orig):
    """A chunk that returns its state unchanged: its optimizer steps and
    everything they moved put back at its end."""
    def body(self):
        state = [*self.gen.state_dict().values(), *self.disc.state_dict().values()]
        state += [t for o in (self.opt_g, self.opt_d) for st in o.state.values()
                  for t in st.values() if torch.is_tensor(t)]
        keep = [t.detach().clone() for t in state]
        orig(self)
        with torch.no_grad():
            for t, k in zip(state, keep):
                t.copy_(k)
    return body


def _stale_chunk(orig):
    """Every step of a chunk on its first step's rows and noise."""
    def body(self):
        self.idx[1:].copy_(self.idx[:1].expand_as(self.idx[1:]))
        self.z[1:].copy_(self.z[:1].expand_as(self.z[1:]))
        orig(self)
    return body


CHUNK_FAULTS = {"unchanged_chunk": _unchanged_chunk, "stale_chunk": _stale_chunk}


@pytest.mark.parametrize("workload", ["batch_mask.masked_epoch", "final.strain_epoch"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_loss", *CHUNK_FAULTS])
def test_training_faults_fail(monkeypatch, workload, fault):
    from strainer_gan_tpu_torch.ops import losses as L
    from strainer_gan_tpu_torch.train import steps as S

    if fault in CHUNK_FAULTS:
        monkeypatch.setattr(S.ChunkedStep, "_body", CHUNK_FAULTS[fault](S.ChunkedStep._body))
    elif fault == "unchanged":
        monkeypatch.setattr(S, "step_body", _unchanged(S.step_body))
    elif fault == "half_batch":
        monkeypatch.setattr(S, "step_body", _half_batch(S.step_body))
    else:  # an answer altered where it is produced: D's loss
        d_loss = L.d_loss
        monkeypatch.setattr(L, "d_loss", lambda *a, **kw: d_loss(*a, **kw) * 1.01)
    correct, rows = _run(workload)
    assert not correct, rows


def test_altered_strain_fails(monkeypatch):
    from strainer_gan_tpu_torch.strain import thresholds as TH

    refine = TH.percentile_refine_mask

    def flipped(losses, ratio, valid=None):
        mask, thr = refine(losses, ratio, valid)
        rows = torch.nonzero(valid if valid is not None else torch.ones_like(mask)).flatten()
        flip = rows[::100]
        mask = mask.clone()
        mask[flip] = ~mask[flip]
        return mask, thr

    monkeypatch.setattr(TH, "percentile_refine_mask", flipped)
    correct, rows = _run("final.strain_epoch")
    assert not correct, rows


@pytest.mark.parametrize("fault", ["half_batch", "altered_score"])
def test_prefilter_faults_fail(monkeypatch, fault):
    from strainer_gan_tpu_torch.kernels import zscore as KZ
    from strainer_gan_tpu_torch.strain import thresholds as TH

    if fault == "half_batch":
        stats = KZ.column_stats

        def half(features, valid=None, std_mode="torch"):
            return stats(features[: features.shape[0] // 2], None, std_mode)
        monkeypatch.setattr(KZ, "column_stats", half)
    else:
        scores = TH.masked_max_abs_z

        def altered(features, valid, std_mode):
            z = scores(features, valid, std_mode).clone()
            z[0] += 1.0
            return z
        monkeypatch.setattr(TH, "masked_max_abs_z", altered)
    correct, rows = _run("final.prefilter")
    assert not correct, rows
