"""Sampler: the host ms an edit spends setting up its two samplings, from
the program's spans in the traced decks: ``sampler.encode`` (inputs to
the card, the source sequence, the encoder) and ``sampler.tables`` (the
fused sampler's per-call decode set-up), over the traced edits. None
where the program has no such spans or the trace saw no device."""


def read(data):
    trace = data.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    spans = trace.get("spans", {})
    edits = sum(1 for h in data.get("handled", ())
                if h["traced"] and h["path"] == "/timerange-change")
    if not edits or "sampler.encode" not in spans \
            or "sampler.tables" not in spans:
        return None
    return 1e3 * (spans["sampler.encode"]["seconds"]
                  + spans["sampler.tables"]["seconds"]) / edits
