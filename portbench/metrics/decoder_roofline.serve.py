"""The VAE decode's analytic least time over its device time."""

from portbench.readers import roofline


def read(facts):
    return roofline(facts, "decoder")
