"""Device ms a training step spends in cuBLAS products (kernel names
sorted by ``harness/frozen.py::kernel_family``) over the traced steps."""


def read(data):
    trace = data.get("trace")
    if not trace or not data.get("traced_steps"):
        return None
    seconds = trace["family_s"].get("cuBLAS products", 0.0)
    if seconds <= 0:
        return None
    return 1e3 * seconds / data["traced_steps"]
