"""Host milliseconds of the program's ``unet.forward`` spans less the
synchronising CUDA calls' time inside them, per forward, in the light
request (``v2vbench/spans.py``), where the trace carries them."""


def read(trace):
    spans = getattr(trace, "spans", None)
    return None if spans is None else spans.dispatch_ms()
