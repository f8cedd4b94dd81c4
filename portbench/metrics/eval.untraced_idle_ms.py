"""Device-idle ms a batch that no host event explains (the profiled span's
gaps ``harness.trace_span`` names "no host event"), read where the
program's spans ran (``beam.decode`` once a batch): the idle the spans
leave unnamed."""

from portbench.spans import ran_once_each, recorded, units


def read(layer):
    n = units(layer, "batches")
    if n is None or not ran_once_each(("beam.decode",), n, recorded()):
        return None
    return 1e3 * layer["span"]["gaps"].get("no host event", 0.0) / n
