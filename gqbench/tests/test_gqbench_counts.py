"""The benchmark's operation and byte counts against counts by hand."""

import pytest

from gqbench.harness import counts, manifest
from gqbench.reference import model as ref_model

R50 = manifest.config("resnet50-cifar.bf16")
VGG = manifest.config("vgg16-cifar.bf16")
U32 = manifest.traffic("hsq-d16.ps32x32")


def test_stem_conv_by_hand():
    stem = ref_model.conv_shapes(R50)[0]
    assert stem == dict(cin=3, cout=64, k=3, stride=1, h=32, w=32, ho=32, wo=32)
    # 3 x 64 taps of 3 x 3 at each of the 32 x 32 outputs
    assert stem["cin"] * stem["cout"] * 9 * 32 * 32 == 1_769_472


def test_macs_and_mfu_count():
    # the dense layer: 2048 x 10; the ResNet-50 total as counted once by hand
    # from its 53 convolutions
    assert ref_model.conv_shapes(R50)[-1]["cin"] == 2048
    assert counts.macs_per_image(R50) == 1_297_829_888
    assert counts.train_flops_per_image(R50) == 6 * 1_297_829_888
    assert counts.macs_per_image(VGG) == 313_201_664
    # 3,000 images a second of ResNet-50 are 2.36% of 989 TFLOP/s
    assert 100 * 3000 * counts.train_flops_per_image(R50) / counts.PEAK_BF16_FLOPS == \
        pytest.approx(2.3620, abs=1e-4)


def test_per_user_dw_count_by_hand():
    convs = counts.per_user_dw_convs(R50)
    # the stem and the 13 stride-1 3x3 convs of the bottlenecks (3 of 16 are strided)
    assert len(convs) == 14
    assert len(counts.per_user_dw_convs(VGG)) == 13
    one = dict(num_users=2, batch_size=4, backend="sim", chips=1)
    spec = dict(R50, compute_dtype="bfloat16")
    stem = [c for c in convs if c["cin"] == 3]
    flops = 2.0 * 9 * 2 * 4 * 32 * 32 * 3 * 64
    moved = 2 * 4 * 32 * 32 * (3 + 64) * 2 + 2 * 64 * 3 * 9 * 4
    want = max(flops / 989e12, moved / 3.35e12) * 1e3
    got = sum(counts.least_ms(
        (2 * 4 * c["h"] * c["w"] * (c["cin"] + c["cout"])) * 2 + 2 * c["cout"] * c["cin"] * 36,
        2.0 * 9 * 2 * 4 * c["h"] * c["w"] * c["cin"] * c["cout"]) for c in stem)
    assert got == pytest.approx(want)
    assert counts.per_user_dw_least_ms(spec, one) > want


def test_hsq_encode_count_by_hand():
    # 23,498,432 compressed elements + a 28,992 pad = 1,470,464 subvectors of 16
    assert counts.hsq_unit_rows(R50, U32) == 1_470_464
    assert counts.hsq_unit_rows(VGG, U32) == 921_600
    rows = 32 * 1_470_464
    want = max(2.0 * rows * 256 * 16 / 989e12,
               (rows * 16 * 2 + rows * 5 + 256 * 16 * 4) / 3.35e12) * 1e3
    assert counts.hsq_encode_least_ms(R50, U32) == pytest.approx(want)


def test_counts_are_per_chip_under_the_mesh_backend():
    mesh = dict(U32, backend="mesh", chips=4)
    u8 = dict(U32, num_users=8)
    assert counts.users_per_chip(mesh) == 8 and counts.chips(mesh) == 4
    assert counts.per_user_dw_least_ms(R50, mesh) == counts.per_user_dw_least_ms(R50, u8)
    assert counts.hsq_encode_least_ms(R50, mesh) == counts.hsq_encode_least_ms(R50, u8)
