"""`conv_s8`'s share of its roofline in the int8 forward: the least time of
the forward's 53 convolutions (`frozen.costs.conv_s8_cost` at their shapes,
each launch bound by its bytes or its operations at the int8 peak, summed
over the launches) over the device time of the kernel that computes them
(`csrc/conv_s8.cu`, symbol `conv_s8_kernel`), per forward. Moves
`images_per_s`."""

from geobench.frozen.costs import conv_s8_forward_bound_s

LAYER = "int8 conv kernel"
SOURCE = "device_trace"
SYMBOLS = ("conv_s8_kernel",)


def read(obs):
    trace = obs["trace"]
    if trace is None or not trace.kernel_launches(*SYMBOLS):
        return None
    cfg, traffic = obs["cell"]["config"], obs["cell"]["traffic"]
    bound, launches = conv_s8_forward_bound_s(
        traffic["batch"] * cfg["n_crops"], cfg["arch"], cfg["crop"])
    forwards = trace.kernel_launches(*SYMBOLS) / launches
    return 100.0 * bound * forwards / trace.kernel_s(*SYMBOLS)
