"""Device milliseconds of the operations launched inside the program's
``layer.conv`` spans (``conv_nhwc``: the convolution, its permutes and copy)
in the light request, per request (``v2vbench/spans.py``), where the trace
carries them."""


def read(trace):
    spans = getattr(trace, "spans", None)
    return None if spans is None else spans.device_ms("layer.conv")
