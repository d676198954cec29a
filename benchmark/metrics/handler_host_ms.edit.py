"""HTTP front end and handlers: the host ms an interaction's two handlers
spend parsing their requests (``serve.parse``: JSON to arrays, the
conditioning, the mask's scan bounds) and building their replies
(``serve.respond``: the conditioning map, the JSON reply, the WAV's
response), from the program's spans in the traced decks, over the traced
edits. None where the program has no such spans or the trace saw no
device."""


def read(data):
    trace = data.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    spans = trace.get("spans", {})
    edits = sum(1 for h in data.get("handled", ())
                if h["traced"] and h["path"] == "/timerange-change")
    if not edits or "serve.parse" not in spans \
            or "serve.respond" not in spans:
        return None
    return 1e3 * (spans["serve.parse"]["seconds"]
                  + spans["serve.respond"]["seconds"]) / edits
