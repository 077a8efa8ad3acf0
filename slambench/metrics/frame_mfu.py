"""The frame's share of the chip's float32 peak, in percent: the decoder
operations of the window's training calls and of the tracker's SDF queries
(query points x neighbours, counted by the benchmark's wrapper around
``tracker_grad.sdf_value_and_grad_cached``) over the window's wall time
times 67 TFLOP/s (at the card's full power limit)."""

from slambench import roofline


def read(run):
    flops = run.train_flops + run.tracker_flops
    if flops <= 0 or run.window_s <= 0:
        return None
    return 100.0 * flops / (run.window_s * roofline.H100_F32_FLOPS)
