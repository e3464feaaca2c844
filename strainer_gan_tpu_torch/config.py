"""Typed configuration (counterpart of `strainer_gan_tpu/config.py`).

A copy of the reference's dataclasses, field for field, so a config means
the same thing in both packages, with the same JSON form (a config written
by either package loads in the other), and of the presets this port runs so
far: the baselines ``basic`` and ``celeba`` (`strainer_gan_tpu/config.py:366-373`),
``final`` (`config.py:523-532`, `# final.py` live section), ``zscore_loss``
(`config.py:455-464`), the feature-space z-score family ``zscore``,
``zscore_elbow`` and ``zscore_dbscan`` (`config.py:411-430`), the
``autoencoder`` and loss-space strainers ``loss_gmm`` and ``loss_ensemble``
(`config.py:431-454`), ``batch_mask``, the in-step quantile mask
(`config.py:465-474`), and the fake-concatenation family
``in_batch_recycle``, ``strainer_gan``, ``fake_concat``,
``strainer_concat_fast`` and ``loss_concat_fast`` (`config.py:476-521`),
and the MNIST family ``mnist8``, ``mnist_8_2``, ``mnist_1_2_8_baseline``
and ``mnist_full`` (`config.py:375-399, 533-548`) with the FID baseline
``celeba_dog_baseline`` (`config.py:401-408`): all 21 presets.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class SourceSpec:
    """One component of a (possibly contaminated) dataset mixture."""

    name: str
    count: Optional[int] = None
    fraction_of_primary: Optional[float] = None
    class_filter: Optional[Tuple[int, ...]] = None
    class_fraction: Optional[float] = None


@dataclass(frozen=True)
class DataConfig:
    sources: Tuple[SourceSpec, ...] = (SourceSpec("synthetic_faces"),)
    image_size: int = 64
    channels: int = 3
    batch_size: int = 128
    mixer: str = "shuffled_combined"
    flatten: bool = False
    # torch DataLoader semantics: the CelebA-family loaders keep
    # drop_last=False (`#%basic.py:76`), one exact partial batch per epoch
    drop_last: bool = True
    seed: int = 999
    auto_batch_divisor: Optional[int] = None


@dataclass(frozen=True)
class ModelConfig:
    arch: str = "dcgan64"
    nz: int = 100
    ngf: int = 64
    ndf: int = 64
    nc: int = 3
    img_size: int = 784
    hidden: Tuple[int, ...] = (256, 512, 1024)
    g_batchnorm: bool = False
    d_dropout: float = 0.0
    # training compute type on the card ("bfloat16" runs the step under
    # autocast); parameters, BN statistics and scoring stay float32
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class StrainConfig:
    method: str = "none"
    feature_extractor: str = "resnet18"
    z_threshold: Optional[float] = 5.0
    z_std_mode: str = "torch"  # "torch" (n-1) | "numpy_eps" (n, +1e-7)
    strict_less: bool = True
    dbscan_eps: float = 20.0
    dbscan_min_samples: int = 3
    loss_ratio: float = 0.2
    prefilter: bool = False
    start_epoch: int = 3
    every_epoch: bool = False
    reset_each_epoch: bool = False
    clean_ratio_schedule: Optional[Tuple[Tuple[int, float], ...]] = None
    # quirk #1 (SURVEY §2.4): `# final.py:443` passes clean_ratio as
    # loss_ratio, inverting the keep fraction
    final_py_ratio_inversion: bool = False
    mask_quantile: float = 0.1
    mask_start_epoch: int = 10
    ae_sigma: float = 2.0
    ae_train_epoch: int = 3
    ae_train_epochs: int = 5
    ae_lr: float = 1e-3
    fake_concat: str = "none"
    fake_pool_fraction: float = 0.1
    fake_concat_start_epoch: int = 3
    in_batch_recycle_quantile: float = 0.1
    # quirk #4: scoring passes leave D in eval mode (`#clean 분포...py:275`)
    bn_eval_after_score: bool = False
    score_batch: int = 512
    # loss_percentile scoring: "band_bf16" scores the bulk in bfloat16 and
    # re-scores the threshold's band in float32 (strain/score.py
    # fused_percentile_refine; the same mask as "f32"); "f32" scores all
    # samples in float32 (strain/score.score_d_losses)
    score_precision: str = "band_bf16"
    band_eps: float = 0.05
    band_capacity_frac: float = 0.0625
    score_unroll: int = 1


@dataclass(frozen=True)
class TrainConfig:
    epochs: int = 5
    lr_g: float = 2e-4
    lr_d: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    adam_defaults: bool = False
    real_label: float = 1.0
    fake_label: float = 0.0
    d_loss_reduction: str = "sum"
    g_before_d: bool = False
    lr_decay_epoch: Optional[int] = None
    lr_decay_factor: float = 0.1
    seed: int = 999
    log_every: int = 50
    sample_every: int = 500
    fixed_noise_n: int = 64
    sample_train_bn: bool = True
    check_finite: bool = False
    # steps a chunk: on the card one CUDA graph replay runs a full chunk
    # (train/steps.py ChunkedStep); 1 runs every step eagerly
    steps_per_dispatch: int = 32
    # the JAX scan's unroll factor; a graph has no counterpart: ignored
    scan_unroll: int = 1
    # a strain event's stats are fetched while its epoch's first chunks run
    # (train/loop.py's deferred path: chunks gated on the device by the
    # step count); applies to chunked epochs without fixed-noise grids
    defer_epoch_stats: bool = True


@dataclass(frozen=True)
class EvalConfig:
    fid: bool = False
    fid_every_epochs: Optional[int] = None
    fid_n_samples: int = 1000
    fid_normalize_activations: bool = False
    feature_distance: bool = False
    wasserstein: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    dp: int = 1
    mesh_axis_name: str = "dp"


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "basic"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    strain: StrainConfig = field(default_factory=StrainConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "ExperimentConfig":
        """The inverse of ``to_json``, as the JAX package reads it: lists
        become tuples (one level of nesting), missing sections and fields
        take their defaults."""
        raw = json.loads(s)

        def _mk(cls, d):
            if d is None:
                return cls()
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name in d:
                    v = d[f.name]
                    if isinstance(v, list):
                        v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
                    kw[f.name] = v
            return cls(**kw)

        sources = tuple(
            _mk(SourceSpec, s) for s in raw.get("data", {}).get("sources", [])
        ) or (SourceSpec("synthetic_faces"),)
        data = _mk(DataConfig, {**raw.get("data", {}), "sources": None})
        data = dataclasses.replace(data, sources=sources)
        return ExperimentConfig(
            name=raw.get("name", "custom"),
            data=data,
            model=_mk(ModelConfig, raw.get("model")),
            strain=_mk(StrainConfig, raw.get("strain")),
            train=_mk(TrainConfig, raw.get("train")),
            eval=_mk(EvalConfig, raw.get("eval")),
            parallel=_mk(ParallelConfig, raw.get("parallel")),
        )


_CELEBA_DATA = DataConfig(
    sources=(SourceSpec("celeba"),), image_size=64, channels=3,
    batch_size=128, drop_last=False,
)
_CELEBA_CIFAR20K = DataConfig(
    sources=(SourceSpec("celeba"), SourceSpec("cifar10", count=20000)),
    mixer="shuffled_combined", drop_last=False,
)
_CELEBA_CIFAR_FULL = DataConfig(
    sources=(SourceSpec("celeba"), SourceSpec("cifar10")),
    mixer="shuffled_combined", drop_last=False,
)
_CELEBA_ANIME = DataConfig(
    sources=(SourceSpec("celeba"), SourceSpec("anime")), mixer="combined",
    drop_last=False,
)
_POOL_EVAL = EvalConfig(fid=True, feature_distance=True, wasserstein=True)
_MNIST_MLP_MODEL = ModelConfig(arch="mlp", nc=1, img_size=784)
_MNIST_128_MODEL = ModelConfig(arch="mlp", nc=1, img_size=784, g_batchnorm=True,
                               d_dropout=0.3)
_MNIST_8 = SourceSpec("mnist", class_filter=(8,))
_MNIST_1_2_8 = (_MNIST_8, SourceSpec("mnist", class_filter=(1,), class_fraction=0.1),
                SourceSpec("mnist", class_filter=(2,), class_fraction=0.1))
_MNIST_TRAIN = TrainConfig(epochs=300, adam_defaults=True, d_loss_reduction="half_mean",
                           g_before_d=True)


def _mnist_data(batch: int, sources: Tuple[SourceSpec, ...], mixer: str = "concat",
                auto_batch_divisor: Optional[int] = None) -> DataConfig:
    return DataConfig(sources=sources, image_size=28, channels=1, batch_size=batch,
                      mixer=mixer, flatten=True, auto_batch_divisor=auto_batch_divisor)


_BASIC = ExperimentConfig(
    name="basic",  # `#%basic.py` — vanilla DCGAN, 5 epochs, no strain
    data=_CELEBA_DATA,
    train=TrainConfig(epochs=5),
)

PRESETS: Dict[str, ExperimentConfig] = {
    "basic": _BASIC,
    "celeba": _BASIC.replace(name="celeba"),  # `#celeba.py` (prints only)
    # -- the MNIST family (`config.py:375-399`): MLP GANs, G updated first
    "mnist8": ExperimentConfig(
        name="mnist8",  # `#8.py` — digit-8-only MLP GAN, G updated before D
        data=_mnist_data(64, (_MNIST_8,), auto_batch_divisor=10),
        model=_MNIST_MLP_MODEL,
        train=dataclasses.replace(_MNIST_TRAIN, lr_g=2e-4, lr_d=2e-4),
    ),
    "mnist_8_2": ExperimentConfig(
        name="mnist_8_2",  # `Untitled-2.py` — 90% 8s + 10% 2s, no strain
        data=_mnist_data(64, (_MNIST_8, SourceSpec("mnist", class_filter=(2,),
                                                   class_fraction=0.1)),
                         auto_batch_divisor=100),
        model=_MNIST_MLP_MODEL,
        train=_MNIST_TRAIN,
    ),
    "mnist_1_2_8_baseline": ExperimentConfig(
        name="mnist_1_2_8_baseline",  # `Untitled-3.py` — 80% 8s + 10% 1s + 10% 2s
        data=_mnist_data(64, _MNIST_1_2_8),
        model=_MNIST_MLP_MODEL,
        train=_MNIST_TRAIN,
    ),
    "celeba_dog_baseline": ExperimentConfig(
        name="celeba_dog_baseline",  # `Untitled-5.py` — CelebA+CIFAR-dog, FID, no strain
        data=DataConfig(sources=(SourceSpec("celeba"),
                                 SourceSpec("cifar10", class_filter=(5,))),
                        mixer="shuffled_combined", drop_last=False),
        train=TrainConfig(epochs=5),
        eval=EvalConfig(fid=True),
    ),
    "zscore": ExperimentConfig(
        name="zscore",  # `#z_score.py` — fixed z>5, applied once at epoch 3
        data=_CELEBA_CIFAR20K,
        train=TrainConfig(epochs=10),
        strain=StrainConfig(method="zscore_fixed", z_threshold=5.0,
                            start_epoch=3, every_epoch=False),
    ),
    "zscore_elbow": ExperimentConfig(
        name="zscore_elbow",  # `#z_score + 엘보우 threshold.py` — prefilter, auto thr
        data=_CELEBA_CIFAR_FULL,
        train=TrainConfig(epochs=10),
        strain=StrainConfig(method="zscore_elbow", z_threshold=None, prefilter=True),
    ),
    "zscore_dbscan": ExperimentConfig(
        name="zscore_dbscan",  # `# z_score + DBSCAN.py` — DBSCAN-calibrated quantile
        data=_CELEBA_CIFAR20K,
        train=TrainConfig(epochs=10),
        strain=StrainConfig(method="zscore_dbscan", prefilter=True, strict_less=False),
    ),
    "autoencoder": ExperimentConfig(
        name="autoencoder",  # `#autoencoder.py` — AE recon-error strain from epoch 3
        data=_CELEBA_CIFAR20K,
        train=TrainConfig(epochs=10),
        strain=StrainConfig(method="autoencoder", start_epoch=3, every_epoch=True,
                            reset_each_epoch=True, ae_sigma=2.0),
    ),
    "loss_gmm": ExperimentConfig(
        name="loss_gmm",  # `#clean 분포...py` — GMM intersection, every epoch
        data=_CELEBA_CIFAR20K,
        train=TrainConfig(epochs=10),
        strain=StrainConfig(method="loss_gmm", start_epoch=0, every_epoch=True,
                            reset_each_epoch=True, bn_eval_after_score=True),
    ),
    "loss_ensemble": ExperimentConfig(
        name="loss_ensemble",  # `# 종합 loss.py` — median{GMM,P75,IQR} + ratio schedule
        data=_CELEBA_CIFAR20K,
        train=TrainConfig(epochs=10, lr_decay_epoch=3),
        strain=StrainConfig(method="loss_ensemble", start_epoch=3, every_epoch=True,
                            reset_each_epoch=True,
                            clean_ratio_schedule=((0, 1.0), (3, 0.9), (5, 0.8), (7, 0.7))),
    ),
    "batch_mask": ExperimentConfig(
        name="batch_mask",  # `# 상위 10% loss값...X.py` — per-batch quantile mask
        data=DataConfig(sources=(SourceSpec("celeba"),
                                 SourceSpec("cifar10", fraction_of_primary=0.1)),
                        mixer="labeled", drop_last=False),
        train=TrainConfig(epochs=20),
        strain=StrainConfig(method="batch_quantile_mask", mask_quantile=0.1,
                            mask_start_epoch=10),
    ),
    "zscore_loss": ExperimentConfig(
        name="zscore_loss",  # `# z_score + loss.py` — z prefilter + loss refine
        data=DataConfig(
            sources=(SourceSpec("celeba"), SourceSpec("cifar10")),
            mixer="shuffled_combined", seed=1, drop_last=False),
        train=TrainConfig(epochs=10, seed=1),
        strain=StrainConfig(method="loss_percentile", prefilter=True,
                            z_threshold=None, start_epoch=3, every_epoch=True,
                            loss_ratio=0.2),
    ),
    # -- the fake-concatenation family (`config.py:476-521`); their eval
    # suites act only under --eval, which the port does not run yet
    "in_batch_recycle": ExperimentConfig(
        name="in_batch_recycle",  # `# 상위 10% 제거해서 fake image에 concate.py`
        data=_CELEBA_DATA,
        train=TrainConfig(epochs=5),
        strain=StrainConfig(method="none", fake_concat="in_batch", fake_concat_start_epoch=3,
                            in_batch_recycle_quantile=0.1),
    ),
    "strainer_gan": ExperimentConfig(
        name="strainer_gan",  # `#strainer gan.py` — TTUR + loss refine + eval suite
        data=_CELEBA_ANIME,
        train=TrainConfig(epochs=10, lr_d=1e-4, lr_g=2e-4),
        strain=StrainConfig(method="loss_percentile", start_epoch=3, every_epoch=True,
                            loss_ratio=0.2),
        eval=_POOL_EVAL,
    ),
    "fake_concat": ExperimentConfig(
        name="fake_concat",  # `# fake concate.py` — z-score outlier pool -> fakes
        data=_CELEBA_ANIME,
        train=TrainConfig(epochs=10, lr_d=1e-4, lr_g=2e-4),
        strain=StrainConfig(method="loss_percentile", start_epoch=3, every_epoch=True,
                            loss_ratio=0.2, fake_concat="pool", fake_pool_fraction=0.1,
                            fake_concat_start_epoch=3),
        eval=_POOL_EVAL,
    ),
    "strainer_concat_fast": ExperimentConfig(
        name="strainer_concat_fast",  # `# strainer gan + concate.py` — prefilter+pool
        data=_CELEBA_ANIME,
        train=TrainConfig(epochs=10, lr_d=1e-4, lr_g=2e-4),
        strain=StrainConfig(method="loss_percentile", prefilter=True, z_threshold=5.0,
                            start_epoch=3, every_epoch=True, loss_ratio=0.2,
                            fake_concat="pool", fake_pool_fraction=0.1,
                            fake_concat_start_epoch=3),
        eval=_POOL_EVAL,
    ),
    "loss_concat_fast": ExperimentConfig(
        name="loss_concat_fast",  # `# loss만 + concate + fast + 10%.py` — no prefilter
        data=_CELEBA_ANIME,
        train=TrainConfig(epochs=10, lr_d=1e-4, lr_g=2e-4),
        strain=StrainConfig(method="loss_percentile", start_epoch=3, every_epoch=True,
                            loss_ratio=0.2, fake_concat="pool", fake_pool_fraction=0.1,
                            fake_concat_start_epoch=3),
        eval=_POOL_EVAL,
    ),
    "final": ExperimentConfig(
        name="final",  # `# final.py` live section — flagship pipeline
        data=_CELEBA_CIFAR_FULL,
        train=TrainConfig(epochs=10, lr_d=1e-4, lr_g=2e-4, lr_decay_epoch=3),
        strain=StrainConfig(
            method="loss_percentile", prefilter=True, z_threshold=5.0,
            start_epoch=3, every_epoch=True,
            clean_ratio_schedule=((0, 1.0), (3, 0.8), (5, 0.6), (7, 0.5)),
            final_py_ratio_inversion=True, bn_eval_after_score=True,
        ),
    ),
    "mnist_full": ExperimentConfig(
        name="mnist_full",  # `# 1,2,8.py` — MNIST full pipeline + periodic FID
        data=_mnist_data(64, _MNIST_1_2_8),
        model=_MNIST_128_MODEL,
        train=TrainConfig(epochs=300, adam_defaults=True, real_label=0.9, fake_label=0.1,
                          d_loss_reduction="half_mean"),
        strain=StrainConfig(method="zscore_fixed", feature_extractor="resnet18_1ch",
                            z_threshold=4.0, z_std_mode="numpy_eps", prefilter=True,
                            # quirk #3 (SURVEY §2.4): the per-epoch loss refinement
                            # of `# 1,2,8.py:263-267` is a no-op; prefilter only
                            start_epoch=3, every_epoch=False),
        eval=EvalConfig(fid=True, fid_every_epochs=100, fid_n_samples=1000,
                        fid_normalize_activations=True),
    ),
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
