"""HTTP front end and handlers: the ms a request waits on its way to the
one handler thread and back (``http.dispatch`` less ``http.handle``),
from the program's spans in the traced decks, per handled request. None
where the program has no such spans or the trace saw no device."""


def read(data):
    trace = data.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    spans = trace.get("spans", {})
    if "http.dispatch" not in spans or "http.handle" not in spans \
            or not spans["http.handle"]["count"]:
        return None
    return 1e3 * (spans["http.dispatch"]["seconds"]
                  - spans["http.handle"]["seconds"]) \
        / spans["http.handle"]["count"]
