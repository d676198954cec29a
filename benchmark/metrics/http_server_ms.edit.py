"""HTTP front end and handlers: the ms an interaction's two requests spend
in the server outside the handler (``http.request`` less
``http.handle``: the body read, the request parsed, the hand-off to the
handler thread and back, the reply written), from the program's spans in
the traced decks, over the traced edits. None where the program has no
such spans or the trace saw no device."""


def read(data):
    trace = data.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    spans = trace.get("spans", {})
    edits = sum(1 for h in data.get("handled", ())
                if h["traced"] and h["path"] == "/timerange-change")
    if not edits or "http.request" not in spans \
            or "http.handle" not in spans:
        return None
    return 1e3 * (spans["http.request"]["seconds"]
                  - spans["http.handle"]["seconds"]) / edits
