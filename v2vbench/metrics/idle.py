"""The device's idle share of the light request's window (one minus the union
of its operations' intervals over the window), in %: from the program's
spans (``v2vbench/spans.py``), where the trace carries them."""


def read(trace):
    spans = getattr(trace, "spans", None)
    return None if spans is None else spans.idle_pct()
