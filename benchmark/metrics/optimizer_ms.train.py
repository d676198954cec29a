"""Training step: the host ms a step spends in its optimizer phase
(``train.optimizer``: the gradients' mean over the data ranks, Adam's
step, the metrics' means), from the program's spans over the traced
steps. None where the program has no such span or the trace saw no
device."""


def read(data):
    trace = data.get("trace")
    if not trace or trace["busy_s"] <= 0 or not data.get("traced_steps"):
        return None
    span = trace.get("spans", {}).get("train.optimizer")
    if span is None:
        return None
    return 1e3 * span["seconds"] / data["traced_steps"]
