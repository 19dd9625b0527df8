"""Analytic FLOPs of every row the window's served batches computed
(padding included) over the union of the batches' dispatch-to-host
intervals and the bf16 peak."""

from portbench.readers import mfu


def read(facts):
    return mfu(facts, "batch_flops", "batch_busy_s")
