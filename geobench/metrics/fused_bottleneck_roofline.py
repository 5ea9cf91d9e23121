"""The stride-1 fused bottleneck kernel's share of its roofline in the bf16
forward: the least time of the blocks it computes (layer1's and layer2's
stride-1 blocks, `frozen.costs.block_cost` at their shapes, each bound by
its bytes or its operations at the bf16 peak) over the device time of the
kernel (`csrc/fused_bottleneck.cu`, symbol `fused_bottleneck_kernel`), per
forward. Moves `images_per_s`."""

from geobench.frozen.costs import fused_bottleneck_forward_bound_s

LAYER = "bf16 bottleneck kernels"
SOURCE = "device_trace"
SYMBOLS = ("fused_bottleneck_kernel",)


def read(obs):
    trace = obs["trace"]
    if trace is None or not trace.kernel_launches(*SYMBOLS):
        return None
    cfg, traffic = obs["cell"]["config"], obs["cell"]["traffic"]
    bound, launches = fused_bottleneck_forward_bound_s(
        traffic["batch"] * cfg["n_crops"], cfg["arch"], cfg["crop"])
    forwards = trace.kernel_launches(*SYMBOLS) / launches
    return 100.0 * bound * forwards / trace.kernel_s(*SYMBOLS)
