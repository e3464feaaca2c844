"""The FLOP and byte counters against counts made by hand."""
from portbench.core import flops as FL

MODEL = {"nz": 100, "ngf": 64, "ndf": 64, "nc": 3}
# D: conv0 3->64 at 32x32, conv1-3 at 16x16, 8x8, 4x4, conv4 512->1 at 1x1
D_FWD = 6_291_456 + 3 * 67_108_864 + 16_384
# G: 100->512 from 1x1, then from 4x4, 8x8, 16x16, 32x32 (transposed)
G_FWD = 1_638_400 + 3 * 67_108_864 + 6_291_456


def test_dcgan_forward_counts():
    assert FL.dcgan_d_forward_flops(MODEL) == D_FWD == 207_634_432
    g, _ = FL.dcgan_convs(**MODEL)
    assert FL.conv_flops(g) == G_FWD == 209_256_448


def test_dcgan_step_counts():
    # G forward; D: two forwards, two backwards (weights + inputs past
    # conv0); G's loss: D forward, D backward to the input, G backward
    # (weights + inputs past its first layer)
    unmasked = (G_FWD + 2 * D_FWD + 2 * (2 * D_FWD - 6_291_456)
                + D_FWD + (D_FWD - 6_291_456) + G_FWD + (G_FWD - 1_638_400))
    assert FL.dcgan_step_flops(MODEL, masked=False) == unmasked == 2_268_332_032
    head = 2 * 67_108_864 + 16_384  # the scoring forward's conv2, conv3, conv4
    assert FL.dcgan_step_flops(MODEL, masked=True) == unmasked + head


def test_resnet18_at_64():
    stem = 2 * 3 * 64 * 49 * 32 * 32
    layer1 = 4 * 2 * 64 * 64 * 9 * 16 * 16
    later = 3 * 67_108_864  # each later stage: 9,437,184 + 3 x 18,874,368 + 1,048,576
    assert FL.resnet18_flops(64) == stem + layer1 + later == 296_091_648


def test_kernel_bytes():
    assert FL.k1_bytes(252_599) == 8 * 252_599
    assert FL.k2a_bytes(70_000, 512) == 70_000 * 512 * 4 + 2 * 512 * 4
    assert FL.k2b_bytes(70_000, 512) == 70_000 * 512 * 4 + 2 * 512 * 4 + 70_000 * 4
