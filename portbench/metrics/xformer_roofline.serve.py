"""The SpatialTransformers' analytic least time over their device time."""

from portbench.readers import roofline


def read(facts):
    return roofline(facts, "xformer")
