"""Analytic FLOPs of the window's training images over the window and the bf16
peak (the train step's share of the chip)."""

from portbench.readers import mfu


def read(facts):
    return mfu(facts, "flops_done", "wall_s")
