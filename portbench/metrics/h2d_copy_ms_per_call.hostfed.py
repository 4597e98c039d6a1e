"""Device milliseconds of the host-to-device copies per call in the traced
window: the time of the operations named ``Memcpy HtoD`` over the entry
calls the window made."""


def read(r):
    if r.trace is None:
        return None
    seconds, copies = r.trace.seconds_of("Memcpy HtoD")
    calls = sum(1 for name, _, _ in r.trace.spans if name == "entry")
    if not copies or not calls:
        return None
    return seconds / calls * 1e3
