"""masked_propagate_roofline: the least time the card could take for the
masked-propagation kernel's launches in the window (the frozen work formula
over each launch's shape, at the data sheet's peaks) over the profiler's
device time of ``masked_propagate_kernel``."""

from hbench.roofline import shapes_bound_s


def read(rec):
    dev, shapes = rec.get("device"), rec["kernel_shapes"]["masked_propagate"]
    if not dev or not shapes:
        return None
    t = sum(s for name, s in dev["device_ops"].items()
            if "masked_propagate_kernel" in name)
    if not t:
        return None
    return 100.0 * shapes_bound_s("masked_propagate", shapes) / t
