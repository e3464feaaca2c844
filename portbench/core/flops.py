"""Operations and bytes counted from shapes, for MFU and roofline shares.

FLOPs are 2 per multiply-add of the convolutions (BatchNorm, activations
and losses are left out: model FLOPs).  A kernel's bytes count each input
byte read once and each output byte written once.
"""
from __future__ import annotations

from typing import List, Tuple

# (c_in, c_out, k, out_h * out_w) of a convolution, or of a transposed one
# by its input's area (the multiply-adds are c_in * c_out * k^2 an input
# position)
Conv = Tuple[int, int, int, int]


def dcgan_convs(nz: int, ngf: int, ndf: int, nc: int, size: int = 64):
    """(G's convolutions, D's convolutions) of the 64x64 DCGAN."""
    g = [(nz, ngf * 8, 4, 1), (ngf * 8, ngf * 4, 4, 4 * 4), (ngf * 4, ngf * 2, 4, 8 * 8),
         (ngf * 2, ngf, 4, 16 * 16), (ngf, nc, 4, 32 * 32)]
    d = [(nc, ndf, 4, (size // 2) ** 2), (ndf, ndf * 2, 4, (size // 4) ** 2),
         (ndf * 2, ndf * 4, 4, (size // 8) ** 2), (ndf * 4, ndf * 8, 4, (size // 16) ** 2),
         (ndf * 8, 1, 4, 1)]
    return g, d


def conv_flops(convs: List[Conv]) -> int:
    return sum(2 * ci * co * k * k * hw for ci, co, k, hw in convs)


def dcgan_step_flops(model: dict, masked: bool) -> int:
    """Model FLOPs of one image through one training step.

    G forward; D forward of the real and of the detached fake batch and
    their backward (weight and input gradients; none into D's input);
    D forward of the fakes for G's loss and its backward to the input only
    (G's update needs no gradient of D's weights); G's backward (weights,
    and inputs but the noise's).  The in-step mask adds D's scoring
    forward of the real batch from the shared stem (the head only)."""
    g, d = dcgan_convs(model["nz"], model["ngf"], model["ndf"], model["nc"])
    fg, fd = conv_flops(g), conv_flops(d)
    d_in0, g_in0 = conv_flops(d[:1]), conv_flops(g[:1])
    d_update = 2 * fd + 2 * (fd + (fd - d_in0))
    g_update = fd + (fd - d_in0) + fg + (fg - g_in0)
    score = conv_flops(d[2:]) if masked else 0
    return fg + d_update + g_update + score


def dcgan_d_forward_flops(model: dict) -> int:
    """Model FLOPs of one image through D's forward (a strain score)."""
    return conv_flops(dcgan_convs(model["nz"], model["ngf"], model["ndf"], model["nc"])[1])


def resnet18_convs(size: int = 64, in_ch: int = 3) -> List[Conv]:
    """The trunk's convolutions at a ``size`` x ``size`` input."""
    s = size // 2  # the 7x7 stride-2 stem
    convs = [(in_ch, 64, 7, s * s)]
    s = (s + 1) // 2  # the stride-2 max-pool (padding 1)
    cin = 64
    for stage, w in enumerate((64, 128, 256, 512)):
        for i in range(2):
            stride = 2 if (stage > 0 and i == 0) else 1
            if stride == 2:
                s = (s + 1) // 2
            convs.append((cin, w, 3, s * s))
            convs.append((w, w, 3, s * s))
            if i == 0 and (stride != 1 or cin != w):
                convs.append((cin, w, 1, s * s))
            cin = w
    return convs


def resnet18_flops(size: int = 64, in_ch: int = 3) -> int:
    """Model FLOPs of one image through the ResNet18 trunk."""
    return conv_flops(resnet18_convs(size, in_ch))


def k1_bytes(n: int) -> int:
    """K1 (BCE scores): n float32 logits in, n float32 losses out."""
    return 8 * n


def k2a_bytes(n: int, d: int) -> int:
    """K2a (column statistics): the (n, d) float32 features in; the mean
    and std out."""
    return 4 * n * d + 8 * d


def k2b_bytes(n: int, d: int) -> int:
    """K2b (max |z| a row): the features, the mean and std in; n scores
    out."""
    return 4 * n * d + 8 * d + 4 * n
