"""The share of the traced window with no device activity."""

from portbench.readers import idle


def read(facts):
    return idle(facts)
