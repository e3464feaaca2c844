"""K2b's redesigned arithmetic, emulated in numpy on the CPU.

The CUDA kernel (``csrc/zscore.cu``, ``row_max_vec_kernel`` and
``row_max_scalar_kernel``) cannot run here, so this test repeats what one
warp does with a row:

* rows of D % 4 == 0 and D <= 512, 16-byte aligned: lane l owns the float4
  column groups q = l + 32 k (k < ceil(D / 128)), columns 4 q .. 4 q + 3;
  a group past D / 4 is padding, loaded as 0 with mean 0 and std 0;
* any other row (D = 30, or misaligned): lane l owns columns l + 32 k;
* each lane takes z = |x - mean| / std, correctly rounded (``__fdiv_rn``),
  and z = 0 where std == 0, then a max that keeps a NaN (``max.NaN``) over
  its columns, starting from 0;
* a butterfly of shuffles (16, 8, 4, 2, 1 lanes apart), the same max,
  leaves the row's max in every lane; lane 0 writes it.

The emulated rows must equal ``row_max_abs_z_plain`` bit for bit (a NaN
matching a NaN), with zero-std columns, NaN and inf entries (a NaN on a
zero-std column gives z = 0, as in the plain version), and stds from 1e-30
to 1e30; and every column must be owned by exactly one lane.
"""
import numpy as np
import pytest
import torch

from strainer_gan_tpu_torch.kernels import zscore as KZ

WARP = 32


def nan_max(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``max.NaN.f32``: NaN if either is NaN, else the larger."""
    return np.where(np.isnan(a) | np.isnan(b), np.float32(np.nan), np.maximum(a, b))


def abs_z(x: np.ndarray, mean: np.float32, std: np.float32) -> np.ndarray:
    d = np.abs((x - mean).astype(np.float32))
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (d / std).astype(np.float32)  # IEEE float32 division, rounded to nearest
    return np.where(std == 0, np.float32(0.0), z).astype(np.float32)


def lane_columns(d: int, vec: bool):
    """For each lane, its columns in the order it visits them; None is a
    padding column of a float4 group past the row's end."""
    if not vec:
        return [list(range(lane, d, WARP)) for lane in range(WARP)]
    groups, dq = -(-d // 128), d // 4
    return [[4 * q + j if q < dq else None for q in (lane + WARP * g for g in range(groups))
             for j in range(4)] for lane in range(WARP)]


def emulate(f: np.ndarray, mean: np.ndarray, std: np.ndarray, vec: bool) -> np.ndarray:
    n, d = f.shape
    lanes = []
    for cols in lane_columns(d, vec):
        m = np.zeros(n, np.float32)
        for c in cols:
            if c is None:
                z = abs_z(np.zeros(n, np.float32), np.float32(0), np.float32(0))
            else:
                z = abs_z(f[:, c], mean[c], std[c])
            m = nan_max(z, m)
        lanes.append(m)
    lanes = np.stack(lanes, axis=1)
    for off in (16, 8, 4, 2, 1):
        lanes = nan_max(lanes[:, np.arange(WARP) ^ off], lanes)
    return lanes[:, 0]


def _inputs(n: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((n, d)) * 3.0 - 1.0).astype(np.float32)
    f[:, 0] = 2.5  # a constant column
    f[1, d // 2] = np.nan
    f[2, 0] = np.nan  # on the zero-std column: z = 0 there
    f[3, 1] = np.inf
    f[4, 2] = np.float32(3e38)
    mean = rng.standard_normal(d).astype(np.float32)
    std = (rng.uniform(0.1, 3.0, d)).astype(np.float32)
    std[0] = 0.0
    std[1], std[2], std[3] = 1e-30, 1e30, 1e-20
    f[5, 3] = mean[3] + np.float32(1e-38)
    return f, mean, std


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.array_equal(np.isnan(a), np.isnan(b))
                and a[~np.isnan(a)].tobytes() == b[~np.isnan(b)].tobytes())


@pytest.mark.parametrize("d,vec", [(512, True), (100, True), (30, False), (512, False)])
def test_lanes_own_every_column_once(d, vec):
    owned = [c for cols in lane_columns(d, vec) for c in cols if c is not None]
    assert sorted(owned) == list(range(d))


@pytest.mark.parametrize("n,d,vec", [(300, 512, True), (257, 100, True), (129, 30, False),
                                     (64, 512, False)])  # (64, 512, False): a misaligned row
def test_emulated_rows_equal_the_plain_version(n, d, vec):
    f, mean, std = _inputs(n, d, n + d)
    plain = KZ.row_max_abs_z_plain(torch.from_numpy(f), torch.from_numpy(mean),
                                   torch.from_numpy(std)).numpy()
    assert _same(emulate(f, mean, std, vec), plain)
    # the statistics the path gives K2b: K2a's plain version, both std modes
    for mode in ("torch", "numpy_eps"):
        m, s = KZ.column_stats_plain(torch.from_numpy(f[6:]), None, mode)
        plain = KZ.row_max_abs_z_plain(torch.from_numpy(f), m, s).numpy()
        assert _same(emulate(f, m.numpy(), s.numpy(), vec), plain)
