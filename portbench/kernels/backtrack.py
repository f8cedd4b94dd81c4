"""The beam's backtrack (``csrc/beam_scan.cu``'s ``backtrack_kernel``), one
launch a batch's decode on either beam route."""

from portbench.counts import least_time

COUNTER = ("dsjax_torch.ops.beam", "BACKTRACK_LAUNCHES")
LAUNCHED_BY = ()


def matches(name: str) -> bool:
    return "backtrack_kernel" in name


def bound(n_t, n_b, k):
    """No arithmetic: the (T, B) steps of K paths read from the int32
    back-pointers and emissions, the (B, K) int32 start slots in and out,
    the (T, B, K) int16 characters out (``ops/beam.py:backtrack``)."""
    return least_time(0.0, n_t * n_b * k * (4 + 4 + 2) + n_b * k * (4 + 4), "float32")
