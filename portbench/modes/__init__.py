"""One module a traffic mode, found by the traffic file's `mode`."""
