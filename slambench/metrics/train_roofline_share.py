"""The training stage's share of its roofline, in percent: the least time of
the work the traced frames' training calls need (iterations x batch x
neighbours decodes at the configuration's widths, with the eikonal
stencil; ``roofline.train_iteration_work``, ``roofline.bound``) over the
device time of every operation launched inside the benchmark's
``slambench.training`` span around ``SlamSystem._train``."""

from slambench import roofline


def read(run):
    gpu_s = run.trace.get("device_s_by_span", {}).get("slambench.training", 0.0)
    flops, nbytes = run.traced_train_work
    if gpu_s <= 0 or flops <= 0:
        return None
    least_ms, _ = roofline.bound(nbytes, flops)
    return 100.0 * least_ms / 1e3 / gpu_s
