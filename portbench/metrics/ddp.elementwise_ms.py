"""Device ms a data-parallel step on rank 0's card in elementwise,
reduction and copy kernels (``harness.kernel_group``'s "other" and
"copy"), over the profiled span."""

from portbench.readers import group_seconds


def read(layer):
    span = layer.get("span")
    if not span:
        return None
    return 1e3 * group_seconds(layer, ("other", "copy")) / span["steps"]
