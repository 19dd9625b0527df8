"""Requests over batch slots (padding included) of the window's batches,
from the engine's own `ServingStats` counters."""


def read(facts):
    occ = facts.get("occupancy")
    return None if occ is None else 100.0 * occ
