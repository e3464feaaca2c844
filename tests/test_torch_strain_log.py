"""The port's Trainer logs strain events as the JAX package's does (CPU, tiny).

The z-score prefilter runs in ``Trainer.setup`` before epoch 0.  The JAX
Trainer applies it without a console line and without a ``strain_quality``
record (`strainer_gan_tpu/train/loop.py:271-277`), and at epoch 0 its
``_log_strain_event`` finds the prefilter's mask already active and logs
nothing either.  Both Trainers run the same tiny ``zscore_elbow`` preset
here, with the same synthetic ResNet18 weights for the features, and must
print the same strain lines (none) and record the same strain quality
(none), from the same epoch-0 mask.
"""
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np

from strainer_gan_tpu.config import get_preset as jax_preset
from strainer_gan_tpu.models.resnet import load_torch_resnet_state_dict, resnet18_features
from strainer_gan_tpu.models.synth_weights import synth_resnet_state_dict
from strainer_gan_tpu.obs.metrics import MetricsLogger as JLogger
from strainer_gan_tpu.train.loop import Trainer as JTrainer

from strainer_gan_tpu_torch import get_preset
from strainer_gan_tpu_torch.train.loop import Trainer

MAX_SYNTH = 96


def _tiny(cfg):
    return cfg.replace(
        data=dataclasses.replace(cfg.data, batch_size=16),
        model=dataclasses.replace(cfg.model, ngf=8, ndf=8, compute_dtype="float32"),
        strain=dataclasses.replace(cfg.strain, score_batch=64),
        train=dataclasses.replace(cfg.train, epochs=1, log_every=1000))


def _strain_lines(text):
    return [line for line in text.splitlines() if line.startswith("Epoch ")]


def test_prefilter_is_not_logged_as_a_strain_event(capsys):
    # the JAX side: its feature extractor with the port's synthetic weights
    fmodel = resnet18_features(3)
    fvars = jax.jit(lambda k, a: fmodel.init({"params": k}, a))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    fvars = jax.tree.map(jnp.asarray, load_torch_resnet_state_dict(
        fvars, synth_resnet_state_dict(fvars)))
    jfeat = jax.jit(lambda x: fmodel.apply(fvars, x, train=False))
    jstream = io.StringIO()
    jcfg = _tiny(jax_preset("zscore_elbow"))
    jtr = JTrainer(jcfg, feature_fn=jfeat, max_synth=MAX_SYNTH,
                   logger=JLogger(log_every=jcfg.train.log_every, stream=jstream))
    jtr.run()

    tr = Trainer(_tiny(get_preset("zscore_elbow")), device="cpu", max_synth=MAX_SYNTH)
    tr.run()
    text = capsys.readouterr().out

    jmask = np.asarray(jtr.engine.base_active)
    assert 0 < jmask.sum() < jmask.size  # the prefilter removed something
    np.testing.assert_array_equal(tr.mask_history[0], jmask)
    assert _strain_lines(text) == _strain_lines(jstream.getvalue()) == []
    assert tr.strain_quality == jtr.strain_quality == []
