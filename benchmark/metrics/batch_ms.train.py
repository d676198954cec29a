"""Training step: the host ms a step spends getting its batch
(``train.batch``: the store's rows gathered, padded and copied to the
card), from the program's spans over the traced steps. None where the
program has no such span or the trace saw no device."""


def read(data):
    trace = data.get("trace")
    if not trace or trace["busy_s"] <= 0 or not data.get("traced_steps"):
        return None
    span = trace.get("spans", {}).get("train.batch")
    if span is None:
        return None
    return 1e3 * span["seconds"] / data["traced_steps"]
