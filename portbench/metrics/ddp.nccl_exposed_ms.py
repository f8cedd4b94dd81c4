"""Device ms a training step in which NCCL's kernels run and no other
device operation does, on rank 0's card over the profiled span
(``harness.trace_span``'s exposed seconds of the "nccl" group): the
gradient exchange that the backward does not hide. None where the trace
shows no NCCL kernel."""


def read(layer):
    span = layer.get("span")
    if not span or not any("nccl" in name.lower() for name in span["ops"]):
        return None
    return 1e3 * span["exposed"].get("nccl", 0.0) / span["steps"]
