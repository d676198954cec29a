"""``fused_train_attention``'s share of its roofline over the traced steps:
the least time of a step's forward and backward calls (the pairs each
mask keeps, at the float32 peak, or their bytes read and written once:
``harness/frozen.py::train_attention_bound_pairs``) times the traced
steps, over the device time of the training-attention kernels, in %."""


def read(data):
    trace = data.get("trace")
    if not trace or not data.get("traced_steps"):
        return None
    seconds = trace["family_s"].get("training attention kernels", 0.0)
    if seconds <= 0:
        return None
    return 100.0 * data["attention_bound_s"] * data["traced_steps"] / seconds
