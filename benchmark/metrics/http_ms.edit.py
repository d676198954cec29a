"""HTTP front end and handlers: the median, over the window's interactions,
of the client's time less the server's ``App.handle`` time of both
requests (the edit and its playback): sockets, HTTP parsing, JSON and the
handler thread's hand-off, in ms."""

import numpy as np


def read(data):
    if not data.get("http_s"):
        return None
    return float(np.median(data["http_s"])) * 1e3
