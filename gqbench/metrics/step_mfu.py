"""The whole step's share of the chip's bf16 peak: the model's forward and
backward operations a training sample (``counts.flops_per_sample``, as the
configuration's model family counts them: 6 x MACs of the conv and dense
shapes for the image families, no recomputation) times the measured
window's samples a second, over 989 TFLOP/s (H100 SXM, dense) a chip the
round runs on."""

from gqbench.harness import counts

UNIT = "%"
LAYER = "whole step"
MOVES = "samples_per_s"
READS = ()


def read(view):
    rate = view.run.get("samples_per_s")
    if not rate:
        return None
    peak = counts.PEAK_BF16_FLOPS * counts.chips(view.traffic)
    return 100.0 * rate * counts.flops_per_sample(view.spec) / peak
